"""The two sklearn split primitives the reference relies on
(`BIOINF_tesi/data_pipe/dataprepare.py:197-306`), in numpy: the port's own
copy of ``embracenet_tpu/utils/skcompat.py``; tests hold the two equal.

``train_test_split(..., shuffle=True)`` and ``KFold(shuffle=True)`` are
bit-for-bit identical to sklearn for the shuffle=True / no-stratify case
(the only case the reference uses): both consume one
``np.random.RandomState(seed)`` draw the same way sklearn's
``ShuffleSplit`` / ``KFold`` do.
"""

from __future__ import annotations

import numpy as np


def train_test_split(arr: np.ndarray, test_size: float,
                     random_state: int, shuffle: bool = True):
    """sklearn ``train_test_split([arr], test_size=..., random_state=...,
    shuffle=True)`` equivalence: one ``RandomState.permutation(n)``,
    test = first ``ceil(test_size*n)`` entries, train = the next
    ``n - n_test`` entries (ShuffleSplit._iter_indices order, unsorted)."""
    arr = np.asarray(arr)
    n = len(arr)
    n_test = int(np.ceil(test_size * n))
    n_train = n - n_test
    if not shuffle:
        return arr[:n_train], arr[n_train:]
    rng = np.random.RandomState(random_state)
    perm = rng.permutation(n)
    return arr[perm[n_test:n_test + n_train]], arr[perm[:n_test]]


def kfold_split(n: int, n_splits: int, random_state: int,
                shuffle: bool = True):
    """sklearn ``KFold(n_splits, shuffle=True, random_state).split(range(n))``
    equivalence -> list of (train_idx, test_idx), both sorted ascending
    (sklearn's ``split`` rebuilds them through a boolean mask)."""
    indices = np.arange(n)
    if shuffle:
        np.random.RandomState(random_state).shuffle(indices)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    out, current = [], 0
    base = np.arange(n)
    for fs in fold_sizes:
        mask = np.zeros(n, dtype=bool)
        mask[indices[current:current + fs]] = True
        out.append((base[~mask], base[mask]))
        current += fs
    return out
