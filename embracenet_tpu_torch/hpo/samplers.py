"""Hyperparameter samplers: random, a lightweight TPE, GP-EI and replay —
the port's own copy of ``embracenet_tpu/hpo/samplers.py``.  They are pure
numpy, so a seed and a history give the same draws in both packages
(tests hold them equal).

Reference uses optuna's ``RandomSampler`` / ``TPESampler`` / ``BoTorchSampler``
(`BIOINF_tesi/models/utils/training_models.py:248-253`).  Notable parity
fact: both TPE and BoTorch default to ``n_startup_trials = 10`` *random*
trials, and every reference study runs only **3 trials**
(`training_models.py:502` via `Kfold_CV.hyper_tuning`) — so the reference's
"TPE"/"BO" sampling never actually leaves random mode.  A real TPE serves
populations beyond the startup budget, and ``"BO"`` is a genuine GP-EI
Bayesian optimizer (GPEISampler, no botorch dependency) — both
behaviour-identical to the reference in its 3-trial regime.
"""

from __future__ import annotations

import math

import numpy as np

from embracenet_tpu_torch.hpo.space import (
    Categorical,
    FloatUniform,
    IntUniform,
    LogUniform,
    model_space,
)


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def sample(self, space: dict, history: list) -> dict:
        return {name: dist.sample(self.rng) for name, dist in space.items()}


class TPESampler:
    """Tree-structured Parzen Estimator over the declarative space.

    history: list of (params, value) with value maximised.  Below
    ``n_startup_trials`` observations, falls back to random (optuna parity).
    """

    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    def sample(self, space: dict, history: list) -> dict:
        history = [(p, v) for p, v in history if v is not None]
        if len(history) < self.n_startup_trials:
            return {n: d.sample(self.rng) for n, d in space.items()}
        order = sorted(history, key=lambda t: -t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(order))))
        good = [p for p, _ in order[:n_good]]
        bad = [p for p, _ in order[n_good:]] or good

        out = {}
        for name, dist in space.items():
            g_vals = [p[name] for p in good if name in p]
            b_vals = [p[name] for p in bad if name in p]
            if not g_vals:
                out[name] = dist.sample(self.rng)
            elif isinstance(dist, (Categorical,)):
                out[name] = self._categorical(dist, g_vals, b_vals)
            elif isinstance(dist, IntUniform):
                choices = list(range(dist.low, dist.high + 1))
                out[name] = self._categorical(Categorical(tuple(choices)),
                                              g_vals, b_vals)
            elif isinstance(dist, (LogUniform, FloatUniform)):
                out[name] = self._continuous(dist, g_vals, b_vals)
            else:
                out[name] = dist.sample(self.rng)
        return out

    def _categorical(self, dist: Categorical, good, bad):
        choices = list(dist.choices)
        prior = 1.0

        def weights(vals):
            w = np.full(len(choices), prior)
            for v in vals:
                w[choices.index(v)] += 1.0
            return w / w.sum()

        lg, lb = weights(good), weights(bad)
        score = lg / np.maximum(lb, 1e-12)
        probs = lg * score
        probs /= probs.sum()
        return choices[int(self.rng.choice(len(choices), p=probs))]

    def _continuous(self, dist, good, bad):
        log = isinstance(dist, LogUniform)
        f = math.log if log else (lambda v: v)
        g = math.exp if log else (lambda v: v)
        lo, hi = f(dist.low), f(dist.high)
        gv = np.asarray([f(v) for v in good])
        bv = np.asarray([f(v) for v in bad])
        bw = max((hi - lo) / max(len(gv), 1) * 1.06, 1e-3 * (hi - lo))

        def logpdf(x, centers):
            d = (x[:, None] - centers[None, :]) / bw
            return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) /
                          (bw * math.sqrt(2 * math.pi)) + 1e-300)

        cands = gv[self.rng.integers(0, len(gv), self.n_candidates)] \
            + self.rng.normal(0, bw, self.n_candidates)
        cands = np.clip(cands, lo, hi)
        ei = logpdf(cands, gv) - logpdf(cands, bv)
        best = g(cands[int(np.argmax(ei))])
        return float(min(max(best, dist.low), dist.high))


class GPEISampler:
    """Gaussian-process expected-improvement sampler (the reference's
    ``BoTorchSampler`` menu entry, `training_models.py:248-249`, without the
    botorch dependency).

    Like BoTorch's default, the first ``n_startup_trials`` draws are random;
    after that a zero-mean GP with an RBF kernel (median-distance
    lengthscale heuristic, standardized targets) is fit to the history and
    EI is maximized over a pool of random candidates plus mutations of the
    incumbents.  Pending trials (value None in history, e.g. the rest of a
    batch from ``sample_n``) enter as "constant liar" observations at the
    history mean, so a batch spreads instead of collapsing onto one point.
    """

    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 n_candidates: int = 512, noise: float = 1e-4):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.noise = noise

    # --- encoding: every param becomes [0,1] features --------------------
    @staticmethod
    def _feat(dist, v, rng=None):
        if isinstance(dist, Categorical):
            choices = list(dist.choices)
            if all(isinstance(c, (int, float)) for c in choices):
                if v is None:
                    return [0.5]
                return [choices.index(v) / max(len(choices) - 1, 1)]
            oh = [0.0] * len(choices)
            if v is not None:
                oh[choices.index(v)] = 1.0
            return oh
        if isinstance(dist, IntUniform):
            if v is None:
                return [0.5]
            return [(v - dist.low) / max(dist.high - dist.low, 1)]
        if isinstance(dist, LogUniform):
            if v is None:
                return [0.5]
            lo, hi = math.log(dist.low), math.log(dist.high)
            return [(math.log(v) - lo) / (hi - lo)]
        if isinstance(dist, FloatUniform):
            if v is None:
                return [0.5]
            return [(v - dist.low) / max(dist.high - dist.low, 1e-12)]
        return [0.0]

    def _encode(self, space, params):
        out = []
        for name in sorted(space):
            out.extend(self._feat(space[name], params.get(name)))
        return out

    def _mutate(self, space, params):
        out = dict(params)
        for name, dist in space.items():
            if self.rng.random() < 0.25:
                out[name] = dist.sample(self.rng)
        return out

    def sample(self, space: dict, history: list) -> dict:
        observed = [(p, v) for p, v in history if v is not None]
        if len(observed) < self.n_startup_trials:
            return {n: d.sample(self.rng) for n, d in space.items()}
        pending = [p for p, v in history if v is None]
        y = np.asarray([v for _, v in observed], np.float64)
        liar = float(y.mean())
        pts = [p for p, _ in observed] + pending
        y = np.concatenate([y, np.full(len(pending), liar)])
        X = np.asarray([self._encode(space, p) for p in pts], np.float64)

        y_mu, y_sd = float(y.mean()), float(y.std()) or 1.0
        yn = (y - y_mu) / y_sd

        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        med = np.median(d2[d2 > 0]) if (d2 > 0).any() else 1.0
        ell2 = max(med, 1e-6)
        K = np.exp(-0.5 * d2 / ell2) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        # candidate pool: random + mutations of the top incumbents
        cands = [
            {n: d.sample(self.rng) for n, d in space.items()}
            for _ in range(self.n_candidates // 2)]
        top = [p for p, _ in sorted(observed, key=lambda t: -t[1])[:4]]
        while len(cands) < self.n_candidates:
            cands.append(self._mutate(space, top[
                int(self.rng.integers(len(top)))]))
        Xc = np.asarray([self._encode(space, p) for p in cands], np.float64)

        d2c = ((Xc[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        Kc = np.exp(-0.5 * d2c / ell2)
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sd = np.sqrt(var)

        best = yn.max()
        z = (mu - best) / sd
        # EI = sd * (z * Phi(z) + phi(z))
        phi = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        Phi = 0.5 * (1.0 + _erf_vec(z / math.sqrt(2.0)))
        ei = sd * (z * Phi + phi)
        return dict(cands[int(np.argmax(ei))])


def _erf_vec(x):
    return np.vectorize(math.erf)(x)


class ReplaySampler:
    """Replays a fixed sequence of flat param dicts (stateful cursor).

    Used for paired benchmarking (replaying the exact trial params the
    reference's sampler drew) and for grid/fixed searches.
    Successive ``sample`` calls — across studies/folds — consume the list in
    order; raises when exhausted."""

    def __init__(self, params_list: list[dict]):
        self.params_list = list(params_list)
        self.cursor = 0

    def sample(self, space: dict, history: list) -> dict:
        if self.cursor >= len(self.params_list):
            raise ValueError("ReplaySampler exhausted: "
                             f"{len(self.params_list)} params provided")
        p = dict(self.params_list[self.cursor])
        self.cursor += 1
        # Conditional per-layer params may be absent (the reference samples
        # them only up to the drawn depth); params_to_hp fills defaults for
        # those, so no validation beyond dict-ness is required here.
        return p


def get_sampler(name: str, seed: int = 0):
    """'random' | 'TPE' | 'BO' (reference sampler menu,
    `training_models.py:248-253`).  All three are behaviour-identical in the
    reference's 3-trial regime (both TPE and BoTorch spend 10 random startup
    trials); beyond it 'BO' is a real GP-EI optimizer."""
    if name == "random":
        return RandomSampler(seed)
    if name == "TPE":
        return TPESampler(seed)
    if name == "BO":
        return GPEISampler(seed)
    raise ValueError(f"unknown sampler {name!r}: use 'random', 'TPE' or 'BO'")


def sample_n(sampler, model: str, n: int, history: list) -> list[dict]:
    space = model_space(model)
    out = []
    hist = list(history)
    for _ in range(n):
        p = sampler.sample(space, hist)
        out.append(p)
        hist.append((p, None))
    return out
