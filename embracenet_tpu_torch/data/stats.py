"""Vectorised rank statistics for feature selection: the port's own copy of
``embracenet_tpu/data/stats.py``.

Replaces the reference's per-column / per-pair scipy loops
(`BIOINF_tesi/data_pipe/utils.py:46-265`) with rank-matrix operations:
one rank transform of the whole feature matrix, then closed-form test
statistics — the all-pairs Spearman screen drops from ~160k sequential
``scipy.stats.spearmanr`` calls (HEPG2: 566 columns) to a single
``corrcoef`` of the rank matrix.

Numerical parity with scipy (asserted for the JAX package in
tests/test_stats.py; tests/test_torch_data.py holds the two packages equal):
  * Kruskal-Wallis (2 groups) with tie correction, chi2 p-value
    (`scipy.stats.kruskal` semantics; used at `data_pipe/utils.py:46-88`),
  * Wilcoxon rank-sum z-test without tie correction
    (`scipy.stats.ranksums`; used at `:92-130`),
  * Spearman rho = Pearson correlation of average ranks
    (`scipy.stats.spearmanr`; used at `:181-207`).
"""

from __future__ import annotations

import numpy as np
from embracenet_tpu_torch.utils.statcompat import chi2_sf, norm_sf, rankdata


def _tie_term(ranked: np.ndarray) -> np.ndarray:
    """sum(t^3 - t) over tie groups, per column. ranked: [N, D]."""
    out = np.zeros(ranked.shape[1])
    for j in range(ranked.shape[1]):
        _, counts = np.unique(ranked[:, j], return_counts=True)
        out[j] = np.sum(counts.astype(np.float64) ** 3 - counts)
    return out


def kruskal_pvalues(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Two-group Kruskal-Wallis p-value per column. x: [N, D], y: [N] binary."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y)
    n = x.shape[0]
    ranks = rankdata(x, axis=0)
    n1 = int((y == 1).sum())
    n0 = int((y == 0).sum())
    r1 = ranks[y == 1].sum(axis=0)
    r0 = ranks[y == 0].sum(axis=0)
    h = 12.0 / (n * (n + 1)) * (r1 ** 2 / n1 + r0 ** 2 / n0) - 3.0 * (n + 1)
    tie = 1.0 - _tie_term(ranks) / (n ** 3 - n)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(tie > 0, h / tie, np.nan)
    return chi2_sf(h, df=1)


def ranksums_pvalues(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Wilcoxon rank-sum (two-sided, no tie correction — scipy.ranksums
    parity) p-value per column."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y)
    n1 = int((y == 1).sum())
    n0 = int((y == 0).sum())
    n = n1 + n0
    ranks = rankdata(x, axis=0)
    s = ranks[y == 1].sum(axis=0)
    expected = n1 * (n + 1) / 2.0
    z = (s - expected) / np.sqrt(n1 * n0 * (n + 1) / 12.0)
    return 2.0 * norm_sf(np.abs(z))


def spearman_matrix(x: np.ndarray) -> np.ndarray:
    """All-pairs Spearman rho: Pearson corrcoef of average ranks."""
    ranks = rankdata(np.asarray(x, np.float64), axis=0)
    with np.errstate(invalid="ignore"):
        return np.corrcoef(ranks, rowvar=False)


def correlated_pairs(x: np.ndarray, columns, threshold: float = 0.75):
    """Pairs with |rho| >= threshold, ordered like the reference.

    Reference quirk preserved (`data_pipe/utils.py:181-207`): pairs are
    stored in a dict *keyed by the rho value* (collisions keep only the last
    combination in itertools order) and then sorted by descending signed rho.
    """
    rho = spearman_matrix(x)
    d = x.shape[1]
    by_corr = {}
    for i in range(d):
        for j in range(i + 1, d):
            r = rho[i, j]
            if np.isfinite(r) and abs(r) >= threshold:
                by_corr[float(r)] = (columns[i], columns[j])
    return [by_corr[r] for r in sorted(by_corr, reverse=True)]


def uncorrelated_with_label(x: np.ndarray, y: np.ndarray, columns,
                            test: str = "kruskal_wallis_test",
                            pval_threshold: float = 0.05) -> set:
    """Columns whose test p-value vs the binary label exceeds the threshold
    (reference `kruskal_wallis_test`/`wilcoxon_test`, `utils.py:46-130`)."""
    if test == "kruskal_wallis_test":
        pvals = kruskal_pvalues(x, y)
    elif test == "wilcoxon_test":
        pvals = ranksums_pvalues(x, y)
    else:
        raise ValueError(f"unknown test: {test}")
    return {c for c, p in zip(columns, pvals) if p > pval_threshold}


def remove_correlated_features(x: np.ndarray, y: np.ndarray, columns,
                               pairs, type_test: str = "wilcoxon_test"):
    """From each correlated pair, drop the member with the larger test
    p-value vs the label (reference `remove_correlated_features`,
    `data_pipe/utils.py:211-265`).

    NOTE (reference quirk): the reference's ``wilcoxon_test_pval`` actually
    computes a *Kruskal-Wallis* p-value (`utils.py:137-158` calls
    ``kruskal``); both of its branch options therefore use KW.  We follow
    honest semantics per ``type_test`` but default the pipeline to KW so the
    realised behaviour matches the reference.

    Returns the list of surviving columns.
    """
    columns = list(columns)
    col_idx = {c: k for k, c in enumerate(columns)}
    alive = set(columns)
    pfunc = kruskal_pvalues if type_test == "kruskal_wallis_test" else ranksums_pvalues
    for c1, c2 in pairs:
        if c1 in alive and c2 in alive:
            sub = x[:, [col_idx[c1], col_idx[c2]]]
            p1, p2 = pfunc(sub, y)
            alive.discard(c2 if p1 <= p2 else c1)
    return [c for c in columns if c in alive]
