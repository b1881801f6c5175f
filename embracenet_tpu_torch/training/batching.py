"""Static batch plans (port of ``embracenet_tpu/training/batching.py``;
host-side index math, device-side gathers).

The reference's ``BalancePos_BatchSampler`` (`BIOINF_tesi/data_pipe/
dataprepare.py:418-454`) shuffles positive and negative indices, splits each
into ``n_batches + 1`` chunks via ``np.array_split``, *reverses* the negative
chunks and zips — so every batch carries positives — then shuffles batch
order.  Two load-bearing quirks we reproduce exactly:

  * ``__iter__`` reseeds ``random.seed(random_state)`` on every call, so the
    batch composition is **identical every epoch** — which means the plan can
    be computed once and baked into a static index matrix.
  * It yields ``n_batches + 1`` batches while ``__len__`` reports
    ``n_batches``; the reference divides summed per-batch train metrics by
    ``len(train_loader)`` (`models/utils/training_models.py:154-155`), i.e.
    by ``n_batches``.  ``BatchPlan.metric_divisor`` preserves that.

Batches are ragged in the reference; here each batch is padded to the max
size with a validity mask, so a plan is one index matrix.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    idx: np.ndarray        # [n_batches, max_bs] int32 gather indices
    mask: np.ndarray       # [n_batches, max_bs] float32 validity
    metric_divisor: int    # reference len(loader) used to average metrics


def balanced_plan(y: np.ndarray, batch_size: int, seed: int = 123) -> BatchPlan:
    """Reference-parity balanced batches (same RNG algorithm => same batches
    as the torch sampler given the same index lists)."""
    y = np.asarray(y)
    pos = list(np.flatnonzero(y == 1))
    neg = list(np.flatnonzero(y == 0))
    n = len(y)
    n_batches = n // batch_size + (1 if n % batch_size else 0)

    rng = random.Random(seed)
    rng.shuffle(pos)
    rng.shuffle(neg)
    pos_chunks = np.array_split(np.asarray(pos, np.int64), n_batches + 1)
    neg_chunks = np.array_split(np.asarray(neg, np.int64), n_batches + 1)
    neg_chunks = list(neg_chunks)[::-1]
    batches = [np.concatenate([p, q]) for p, q in zip(pos_chunks, neg_chunks)]
    rng.shuffle(batches)
    batches = [b for b in batches if len(b)]  # array_split may yield empties

    max_bs = max(len(b) for b in batches)
    idx = np.zeros((len(batches), max_bs), np.int32)
    mask = np.zeros((len(batches), max_bs), np.float32)
    for i, b in enumerate(batches):
        idx[i, :len(b)] = b
        mask[i, :len(b)] = 1.0
    return BatchPlan(idx=idx, mask=mask, metric_divisor=n_batches)


def shift_plan(plan: BatchPlan, offset: int) -> BatchPlan:
    """The same plan indexing rows ``offset`` deeper into a concatenated
    dataset (fold-fused populations train several CV folds in one program;
    each fold's plan addresses its own row range).  Masked padding slots
    shift too — they point at the fold's row 0 and stay masked."""
    return BatchPlan(idx=(plan.idx + np.int32(offset)).astype(np.int32),
                     mask=plan.mask, metric_divisor=plan.metric_divisor)


def eval_plan(n: int, batch_size: int, seed: int = 123) -> BatchPlan:
    """Shuffled fixed-size batching (reference test loader:
    ``DataLoader(batch_size=batch_size*2, shuffle=True)``,
    `training_models.py:477`; caller passes the doubled size).

    Documented divergence: the reference reshuffles the test loader every
    epoch; here the order is shuffled once so the plan stays one index
    matrix.  Only the batch-mean aggregation of per-batch metrics is sensitive
    to composition, and the effect is far below the reference's own
    fold-to-fold std."""
    order = np.random.default_rng(seed).permutation(n).astype(np.int32)
    n_batches = -(-n // batch_size)
    idx = np.zeros((n_batches, batch_size), np.int32)
    mask = np.zeros((n_batches, batch_size), np.float32)
    for i in range(n_batches):
        chunk = order[i * batch_size:(i + 1) * batch_size]
        idx[i, :len(chunk)] = chunk
        mask[i, :len(chunk)] = 1.0
    return BatchPlan(idx=idx, mask=mask, metric_divisor=n_batches)
