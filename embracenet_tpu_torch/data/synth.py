"""Synthetic benchmark generators with *known* per-modality Bayes ceilings.

The reference's value claim is a model ordering (EmbraceNet/Concat fusion vs
single-modality FFNN/CNN) on real enhancer/promoter data it does not ship.
Planted-signal sweeps where every family saturates say nothing about that
ordering, so this module builds tasks where the two modalities carry
*complementary* signal and no single-modality model — however good — can
reach the fused ceiling:

  * a latent per-row gate ``g ~ Bernoulli(gate_p)`` decides which modality
    carries the positive-class evidence: positives with ``g=1`` shift a few
    tabular features; positives with ``g=0`` carry a sequence motif;
  * the gate itself is weakly visible in the tabular view (feature 0), so a
    fusion model can learn *when to trust which modality* — exactly the
    conditional-reliability story EmbraceNet's stochastic embracement is
    built for (reference `EmbraceNetMultimodal.py:34-88`);
  * :func:`oracle_scores` returns the exact posterior P(y=1 | view) under
    the generative model for each view and for the fused view, giving
    closed-form AUPRC ceilings to place model scores against.

The port's own copy of ``embracenet_tpu/data/synth.py``.
"""

from __future__ import annotations

import numpy as np

MOTIF = np.array([0, 1, 2, 3, 0, 2], dtype=np.uint8)


def gated_multimodal_task(n: int, d: int = 64, prevalence: float = 0.15,
                          gate_p: float = 0.5, tab_shift: float = 1.2,
                          n_tab_features: int = 6,
                          motif_pos_rate: float = 0.95,
                          motif_bg_rate: float = 0.03, gate_vis: float = 0.3,
                          seq_len: int = 256, seed: int = 0) -> dict:
    """-> {"ffnn": [n, d] f32, "cnn": [n, L] uint8 codes, "y": [n] i64,
    "g": [n] i64 (latent gate, for diagnostics — not a model input)}.

    Evidence layout:
      * feature 0 = ``gate_vis * g`` + N(0,1)  (weak gate observation)
      * features 1..n_tab_features: + ``tab_shift`` iff ``y=1 and g=1``
      * motif planted at a random offset with prob ``motif_pos_rate`` iff
        ``y=1 and g=0``, else ``motif_bg_rate`` (background)
    """
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < prevalence).astype(np.int64)
    g = (rng.random(n) < gate_p).astype(np.int64)

    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] += (gate_vis * g).astype(np.float32)
    tab_rows = (y == 1) & (g == 1)
    x[tab_rows, 1:1 + n_tab_features] += tab_shift

    codes = rng.integers(0, 4, size=(n, seq_len)).astype(np.uint8)
    motif_rate = np.where((y == 1) & (g == 0), motif_pos_rate, motif_bg_rate)
    has_motif = rng.random(n) < motif_rate
    offs = rng.integers(0, seq_len - len(MOTIF), size=n)
    for i in np.flatnonzero(has_motif):
        codes[i, offs[i]:offs[i] + len(MOTIF)] = MOTIF
    return {"ffnn": x, "cnn": codes, "y": y, "g": g,
            "_has_motif": has_motif.astype(np.int64)}


def _motif_present(codes: np.ndarray) -> np.ndarray:
    """Exact scan for MOTIF as a contiguous substring (vectorised)."""
    L, m = codes.shape[1], len(MOTIF)
    hits = np.zeros(codes.shape[0], dtype=bool)
    for off in range(L - m + 1):
        hits |= (codes[:, off:off + m] == MOTIF[None, :]).all(axis=1)
    return hits


def oracle_scores(data: dict, prevalence: float, gate_p: float,
                  tab_shift: float, n_tab_features: int,
                  motif_pos_rate: float, motif_bg_rate: float,
                  gate_vis: float) -> dict:
    """Exact posteriors P(y=1 | view) under the generative model, for the
    tabular view, the sequence view, and both — the Bayes ceilings any model
    of that view is bounded by.

    Sequence-view subtlety: a background motif can also appear *by chance*
    in random sequence; the detector below observes presence-as-substring,
    whose likelihood under each class mixes the planted rate with the chance
    rate, so the chance rate is estimated from the planted-flag diagnostics
    (exact bookkeeping, not an approximation, since ``_has_motif`` records
    planting).
    """
    x = np.asarray(data["ffnn"], np.float64)
    present = _motif_present(np.asarray(data["cnn"]))
    planted = np.asarray(data["_has_motif"], bool)
    # chance occurrence rate among non-planted rows
    chance = float(present[~planted].mean()) if (~planted).any() else 0.0

    def seq_lik(rate):
        eff = rate + (1 - rate) * chance  # planted or by chance
        return np.where(present, eff, 1 - eff)

    p, q = prevalence, gate_p
    # log-likelihood of the tabular block under each (y, g) combination
    f0 = x[:, 0]
    tab = x[:, 1:1 + n_tab_features]

    def lg0(vis):  # feature-0 likelihood given g
        return -0.5 * (f0 - vis) ** 2

    def ltab(shift):  # informative-features likelihood given (y, g)
        return -0.5 * ((tab - shift) ** 2).sum(axis=1)

    # components: (y, g) with priors p/q factorised
    combos = [
        (0, 0, (1 - p) * (1 - q)),
        (0, 1, (1 - p) * q),
        (1, 0, p * (1 - q)),
        (1, 1, p * q),
    ]
    out = {}
    for view in ("tab", "seq", "both"):
        loglik = np.zeros((len(combos), len(x)))
        for ci, (yy, gg, prior) in enumerate(combos):
            ll = np.full(len(x), np.log(prior))
            if view in ("tab", "both"):
                ll = ll + lg0(gate_vis * gg)
                ll = ll + ltab(tab_shift if (yy == 1 and gg == 1) else 0.0)
            if view in ("seq", "both"):
                rate = motif_pos_rate if (yy == 1 and gg == 0) \
                    else motif_bg_rate
                ll = ll + np.log(np.maximum(seq_lik(rate), 1e-300))
            loglik[ci] = ll
        # per-row logsumexp normalisation keeps the num/den ratio exact
        w = np.exp(loglik - loglik.max(axis=0, keepdims=True))
        num = sum(w[ci] for ci, (yy, _, _) in enumerate(combos) if yy == 1)
        out[view] = num / np.maximum(w.sum(axis=0), 1e-300)
    return out
