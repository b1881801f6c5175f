"""Batch plans, a copy of the port's ``training/batching.py``: the
reference's ``BalancePos_BatchSampler`` (every batch carries positives, the
same batches every epoch) and the evaluation loader's fixed batches."""

from __future__ import annotations

import random

import numpy as np


def balanced_plan(y: np.ndarray, batch_size: int, seed: int = 123):
    """-> ``(idx [n_batches, width] int64, mask [n_batches, width]
    float32)``: positives and negatives shuffled, each split into
    ``n_batches + 1`` chunks, the negative chunks reversed and zipped, the
    batches shuffled, padded to the widest with masked rows."""
    y = np.asarray(y)
    pos = list(np.flatnonzero(y == 1))
    neg = list(np.flatnonzero(y == 0))
    n = len(y)
    n_batches = n // batch_size + (1 if n % batch_size else 0)
    rng = random.Random(seed)
    rng.shuffle(pos)
    rng.shuffle(neg)
    pos_chunks = np.array_split(np.asarray(pos, np.int64), n_batches + 1)
    neg_chunks = list(np.array_split(np.asarray(neg, np.int64),
                                     n_batches + 1))[::-1]
    batches = [np.concatenate([p, q]) for p, q in zip(pos_chunks, neg_chunks)]
    rng.shuffle(batches)
    batches = [b for b in batches if len(b)]
    width = max(len(b) for b in batches)
    idx = np.zeros((len(batches), width), np.int64)
    mask = np.zeros((len(batches), width), np.float32)
    for i, b in enumerate(batches):
        idx[i, :len(b)] = b
        mask[i, :len(b)] = 1.0
    return idx, mask


def eval_batches(n: int, batch_size: int) -> int:
    """How many evaluation batches of ``batch_size`` rows ``n`` windows
    take (each is padded to ``batch_size`` rows)."""
    return -(-n // batch_size)
