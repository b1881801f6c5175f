"""Class rebalancing and augmentation as array ops: the port's own copy of
``embracenet_tpu/data/sampling.py``; tests hold the two equal.

Parity targets in `BIOINF_tesi/data_pipe/utils.py`:
  * ``get_imbalance`` (pos/neg, rounded) `:280-306`; ``get_IR`` `:309-323`;
  * ``compute_rebalancing_obs`` `:652-685`;
  * ``double_rebalance`` (resample positives) `:342-380`;
  * ``reverse_strand_rebalance`` (complement-strand copies of positives)
    `:384-425`;
  * ``reverse_strand_augment`` (double everything, cap negatives to keep the
    0.1 ratio when imbalanced) `:429-525`;
  * SMOTE rebalance/augment (`data_rebalancing` `:530-584`,
    ``data_augmentation`` `:588-648`).

SMOTE is implemented directly (imblearn semantics: new = x + u * (nn - x)
with u ~ U[0,1), k=5 neighbours among the minority class); synthetic rows are
*appended* after the originals, matching imblearn's output ordering that the
reference's asserts rely on (`utils.py:510` comment).  The neighbour lists
come in the order of the JAX package's native kNN
(``embracenet_tpu/runtime/ioaccel.cpp`` ``enc_knn``): nearest first, ties
by row index, so a seed picks the same neighbours in both packages.
"""

from __future__ import annotations

import numpy as np

from embracenet_tpu_torch.data.codec import complement_codes

#: elements of one query chunk's distance matrix in :func:`knn_sorted`
_KNN_CHUNK = 1 << 21


def get_imbalance(y=None, n_pos=None, n_neg=None, n_decim: int = 3) -> float:
    if y is not None:
        y = np.asarray(y)
        n_pos = int((y == 1).sum())
        n_neg = int((y == 0).sum())
    return float(np.round(n_pos / n_neg, n_decim))


def get_ir(y) -> float:
    y = np.asarray(y)
    return float((y == 0).sum() / (y == 1).sum())


def compute_rebalancing_obs(rebalance_threshold: float = 0.1, y=None,
                            n_pos=None, n_neg=None) -> int:
    if y is not None:
        y = np.asarray(y)
        n_pos = int((y == 1).sum())
        n_neg = int((y == 0).sum())
    imbalance = get_imbalance(n_pos=n_pos, n_neg=n_neg)
    if imbalance > rebalance_threshold:
        return int(n_pos / rebalance_threshold - n_neg)
    if imbalance < rebalance_threshold:
        return int(n_neg * rebalance_threshold - n_pos)
    return 0


# ---------------------------------------------------------------------------
# SMOTE
# ---------------------------------------------------------------------------

def knn_sorted(x: np.ndarray, k: int) -> np.ndarray:
    """[n, k] indices of each row's k nearest other rows of ``x``, nearest
    first, ties by row index, by squared distances summed feature by
    feature in float64, as the native kNN sums them.

    One matrix product gives every distance to within its rounding bound
    (``slack``); only the rows within twice that bound of a row's k-th
    smallest are summed feature by feature, so the order is the exact
    sums' order at the cost of a product."""
    x = np.asarray(x, np.float64)
    n, d = x.shape
    sq = np.einsum("ij,ij->i", x, x)
    slack = 8 * (d + 2) * np.finfo(np.float64).eps * (sq + sq.max())
    out = np.empty((n, k), np.int64)
    step = max(1, _KNN_CHUNK // max(n, 1))
    for lo in range(0, n, step):
        q = x[lo:lo + step]
        rows = np.arange(len(q))
        d2 = sq[lo:lo + len(q), None] + sq[None, :] - 2.0 * (q @ x.T)
        d2[rows, rows + lo] = np.inf
        limit = (np.partition(d2, k - 1, axis=1)[:, k - 1]
                 + 2 * slack[lo:lo + len(q)])
        for r in rows:
            near = np.flatnonzero(d2[r] <= limit[r])
            diff = x[near] - q[r]
            exact = np.cumsum(diff * diff, axis=1)[:, -1]   # in feature order
            out[lo + r] = near[np.argsort(exact, kind="stable")[:k]]
    return out


def smote_oversample(x: np.ndarray, y: np.ndarray, n_new_pos: int = None,
                     n_new_neg: int = 0, k_neighbors: int = 5,
                     random_state: int = 42):
    """Generate synthetic samples by minority-class interpolation.

    Appends ``n_new_pos`` synthetic positives (and optionally synthetic
    negatives) after the original rows.  Matches imblearn SMOTE's sample
    construction; neighbour search is exact brute force.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y)
    rng = np.random.default_rng(random_state)
    new_x, new_y = [x], [y]

    # imblearn appends synthetic class-0 rows before class-1 rows; the
    # reference's multimodal alignment relies on that order (utils.py:518-520)
    for cls, n_new in ((0, n_new_neg or 0), (1, n_new_pos or 0)):
        if n_new <= 0:
            continue
        xc = x[y == cls]
        if len(xc) < 2:
            raise ValueError(f"SMOTE needs >= 2 samples of class {cls}")
        k = min(k_neighbors, len(xc) - 1)
        nn_idx = knn_sorted(xc, k)
        base = rng.integers(0, len(xc), n_new)
        pick = nn_idx[base, rng.integers(0, k, n_new)]
        gap = rng.random((n_new, 1))
        synth = xc[base] + gap * (xc[pick] - xc[base])
        new_x.append(synth)
        new_y.append(np.full(n_new, cls, y.dtype))

    return np.concatenate(new_x), np.concatenate(new_y)


# ---------------------------------------------------------------------------
# rebalancing (used per CV fold when pos/neg < threshold)
# ---------------------------------------------------------------------------

def double_rebalance(x, y, rebalance_threshold=0.1, random_state=123):
    """Resample positives with replacement up to the target ratio
    (`utils.py:342-380`)."""
    x = np.asarray(x)
    y = np.asarray(y)
    pos = np.flatnonzero(y == 1)
    n_obs = compute_rebalancing_obs(rebalance_threshold, y=y)
    rng = np.random.RandomState(random_state)
    take = pos[rng.randint(0, len(pos), n_obs)]
    return (np.concatenate([x, x[take]]),
            np.concatenate([y, np.ones(n_obs, y.dtype)]))


def reverse_strand_rebalance(codes, y, rebalance_threshold=0.1,
                             random_state=123):
    """Append complement-strand copies of positives up to the target ratio
    (`utils.py:384-425`)."""
    codes = np.asarray(codes)
    y = np.asarray(y)
    pos = np.flatnonzero(y == 1)
    comp = complement_codes(codes[pos])
    n_obs = compute_rebalancing_obs(rebalance_threshold, y=y)
    rng = np.random.RandomState(random_state)
    take = rng.randint(0, len(pos), n_obs)
    new_codes = np.concatenate([codes, comp[take]])
    new_y = np.concatenate([y, np.ones(n_obs, y.dtype)])
    assert get_imbalance(new_y, n_decim=2) == rebalance_threshold
    return new_codes, new_y


def data_rebalancing(x, y, sequence: bool = False,
                     type_augm_genfeatures: str = "smote",
                     rebalance_threshold: float = 0.1,
                     random_state: int = 123):
    """Dispatcher parity with `utils.py:530-584`."""
    if type_augm_genfeatures not in ("smote", "double"):
        raise ValueError("type_augm_genfeatures must be 'smote' or 'double'")
    if get_imbalance(y) >= rebalance_threshold:
        return x, y
    if sequence:
        return reverse_strand_rebalance(x, y, rebalance_threshold, random_state)
    if type_augm_genfeatures == "smote":
        # imblearn sampling_strategy=ratio: n_pos_final = ratio * n_neg
        y_arr = np.asarray(y)
        n_pos = int((y_arr == 1).sum())
        n_neg = int((y_arr == 0).sum())
        n_new = int(rebalance_threshold * n_neg) - n_pos
        return smote_oversample(x, y, n_new_pos=max(n_new, 0),
                                random_state=random_state)
    return double_rebalance(x, y, rebalance_threshold, random_state)


# ---------------------------------------------------------------------------
# augmentation (multimodal `augmentation=True` path)
# ---------------------------------------------------------------------------

def reverse_strand_augment(codes, y, rebalance_threshold=0.1,
                           random_state=123):
    """Complement-strand augmentation (`utils.py:429-525`): double positives
    and negatives; when originally imbalanced, cap added negatives so the
    final pos/neg ratio equals the threshold.  Append order: negatives before
    positives (imblearn-compatible ordering, reference comment `:518-520`)."""
    codes = np.asarray(codes)
    y = np.asarray(y)
    imbalance_pre = get_imbalance(y)
    pos = np.flatnonzero(y == 1)
    neg = np.flatnonzero(y == 0)
    comp_pos = complement_codes(codes[pos])
    comp_neg = complement_codes(codes[neg])

    if imbalance_pre < rebalance_threshold:
        y_doubled_pos = np.concatenate([y, np.ones(len(pos), y.dtype)])
        n_obs = compute_rebalancing_obs(0.1, y=y_doubled_pos)
        rng = np.random.RandomState(random_state)
        take = rng.randint(0, len(neg), n_obs)
        new_codes = np.concatenate([codes, comp_neg[take], comp_pos])
        new_y = np.concatenate([y, np.zeros(n_obs, y.dtype),
                                np.ones(len(pos), y.dtype)])
        assert get_imbalance(new_y, n_decim=2) == rebalance_threshold
    else:
        new_codes = np.concatenate([codes, comp_neg, comp_pos])
        new_y = np.concatenate([y, np.zeros(len(neg), y.dtype),
                                np.ones(len(pos), y.dtype)])
        assert len(new_codes) == 2 * len(codes)
    return new_codes, new_y


def data_augmentation(x, y, sequence: bool = False,
                      rebalance_threshold: float = 0.1,
                      random_state: int = 123):
    """Dataset doubling via SMOTE (tabular) or strand complement (sequence),
    with the 0.1-ratio floor when imbalanced (`utils.py:588-648`)."""
    y_arr = np.asarray(y)
    if sequence:
        return reverse_strand_augment(x, y, rebalance_threshold, random_state)

    n_pos = int((y_arr == 1).sum())
    n_neg = int((y_arr == 0).sum())
    if get_imbalance(y_arr) < rebalance_threshold:
        target_pos = n_pos * 2
        target_neg = n_neg + compute_rebalancing_obs(
            0.1, n_pos=target_pos, n_neg=n_neg)
        x2, y2 = smote_oversample(x, y_arr, n_new_pos=target_pos - n_pos,
                                  n_new_neg=target_neg - n_neg,
                                  random_state=random_state)
        assert get_imbalance(y2, n_decim=2) == rebalance_threshold
        return x2, y2
    x2, y2 = smote_oversample(x, y_arr, n_new_pos=n_pos, n_new_neg=n_neg,
                              random_state=random_state)
    assert len(x2) == 2 * len(np.asarray(x))
    return x2, y2
