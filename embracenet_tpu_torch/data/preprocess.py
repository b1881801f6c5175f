"""Preprocessing: scaling, imputation, feature selection (the port's own copy
of ``embracenet_tpu/data/preprocess.py``, numpy in float64).

Pipeline parity with `BIOINF_tesi/data_pipe/dataprepare.py` (``Data_Prepare``):
  1. RobustScaler then MinMaxScaler fit on the *full* matrix — the reference
     fits before any split (`dataprepare.py:83-90`); that leakage-by-design
     is preserved for parity.  Callers wanting sound semantics can fit
     :class:`ScalerStats` on a training subset and ``transform`` the rest.
  2. MICE-style imputation (`:93-101` via miceforest): replaced by a
     deterministic iterative ridge imputer with optional mean-matching —
     miceforest parity is not bit-required (the reference silently skips
     imputation on any error).
  3. Label-relevance filter: drop columns with test p-value > 0.05 under
     Kruskal-Wallis and/or rank-sums, union or intersection of drop sets
     (`:112-176`).
  4. Redundancy filter: all-pairs Spearman >= threshold; from each pair drop
     the member with the larger label-test p-value (`:181-193`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from embracenet_tpu_torch.data import stats


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScalerStats:
    median: np.ndarray
    iqr: np.ndarray
    post_min: np.ndarray
    post_range: np.ndarray

    def transform(self, x: np.ndarray) -> np.ndarray:
        iqr = np.where(self.iqr == 0, 1.0, self.iqr)
        z = (x - self.median) / iqr
        rng = np.where(self.post_range == 0, 1.0, self.post_range)
        return (z - self.post_min) / rng


def fit_robust_minmax(x: np.ndarray) -> ScalerStats:
    """sklearn RobustScaler -> MinMaxScaler parity (NaN-aware)."""
    x = np.asarray(x, np.float64)
    median = np.nanmedian(x, axis=0)
    q75 = np.nanpercentile(x, 75, axis=0)
    q25 = np.nanpercentile(x, 25, axis=0)
    iqr = q75 - q25
    z = (x - median) / np.where(iqr == 0, 1.0, iqr)
    post_min = np.nanmin(z, axis=0)
    post_range = np.nanmax(z, axis=0) - post_min
    return ScalerStats(median, iqr, post_min, post_range)


def robust_minmax_scale(x: np.ndarray) -> np.ndarray:
    return fit_robust_minmax(x).transform(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# imputation (MICE equivalent)
# ---------------------------------------------------------------------------

def iterative_impute(x: np.ndarray, n_iter: int = 6, ridge: float = 1e-3,
                     mean_match_candidates: int = 0,
                     random_state: int = 100) -> np.ndarray:
    """Deterministic MICE-style imputation with ridge regressions.

    Each column with missing values is repeatedly regressed on all other
    columns (current fill), ``n_iter`` rounds (reference runs miceforest for
    6 iterations, `data_pipe/utils.py:18-42`).  ``mean_match_candidates > 0``
    enables predictive mean matching: the prediction is replaced by the
    observed value whose prediction is among the k nearest (reference uses
    k=10).
    """
    x = np.asarray(x, np.float64).copy()
    n, d = x.shape
    missing = np.isnan(x)
    if not missing.any():
        return x
    col_has_missing = np.flatnonzero(missing.any(axis=0))
    col_means = np.nanmean(x, axis=0)
    col_means = np.where(np.isnan(col_means), 0.0, col_means)
    for j in range(d):
        x[missing[:, j], j] = col_means[j]

    rng = np.random.default_rng(random_state)
    for _ in range(n_iter):
        for j in col_has_missing:
            obs = ~missing[:, j]
            mis = missing[:, j]
            if obs.sum() < 2 or mis.sum() == 0:
                continue
            others = np.delete(np.arange(d), j)
            a = x[np.ix_(obs, others)]
            b = x[obs, j]
            a_mean = a.mean(axis=0)
            b_mean = b.mean()
            ac = a - a_mean
            gram = ac.T @ ac + ridge * np.eye(len(others))
            coef = np.linalg.solve(gram, ac.T @ (b - b_mean))
            pred_mis = (x[np.ix_(mis, others)] - a_mean) @ coef + b_mean
            if mean_match_candidates > 0:
                pred_obs = ac @ coef + b_mean
                k = min(mean_match_candidates, len(pred_obs))
                dist = np.abs(pred_obs[None, :] - pred_mis[:, None])
                cand = np.argpartition(dist, k - 1, axis=1)[:, :k]
                pick = cand[np.arange(len(pred_mis)),
                            rng.integers(0, k, len(pred_mis))]
                x[mis, j] = b[pick]
            else:
                x[mis, j] = pred_mis
    return x


# ---------------------------------------------------------------------------
# feature selection
# ---------------------------------------------------------------------------

def select_features(x: np.ndarray, y: np.ndarray, columns,
                    type_test="kruskal_wallis_test",
                    intersection: bool = False,
                    pval_threshold: float = 0.05,
                    spearman_threshold: float = 0.85,
                    verbose: bool = False):
    """Label-relevance filter then redundancy filter.

    Returns (selected_x, selected_columns).  Defaults mirror
    ``Build_DataLoader_Pipeline`` (`dataprepare.py:459-542`:
    kruskal_wallis_test, union, 0.05, spearman 0.85).

    NOTE: in the redundancy step the reference's pair-resolution helper
    computes Kruskal-Wallis p-values regardless of its ``type_test`` argument
    (`data_pipe/utils.py:137-175` — both ``*_test_pval`` helpers call
    ``kruskal``); we pass KW explicitly to match realised behaviour.
    """
    columns = list(columns)
    if isinstance(type_test, str):
        type_test = [type_test]

    drop_sets = [stats.uncorrelated_with_label(x, y, columns, t, pval_threshold)
                 for t in type_test]
    to_drop = set.intersection(*drop_sets) if intersection else set.union(*drop_sets)
    keep = [c for c in columns if c not in to_drop]
    keep_idx = [columns.index(c) for c in keep]
    x1 = x[:, keep_idx]
    if verbose:
        print(f"label-relevance filter dropped {len(to_drop)} columns")

    pairs = stats.correlated_pairs(x1, keep, spearman_threshold)
    survivors = stats.remove_correlated_features(
        x1, y, keep, pairs, type_test="kruskal_wallis_test")
    surv_idx = [keep.index(c) for c in survivors]
    if verbose:
        print(f"redundancy filter dropped {len(keep) - len(survivors)} columns")
    return x1[:, surv_idx], survivors
