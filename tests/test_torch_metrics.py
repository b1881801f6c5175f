"""Port metrics vs the JAX package on the same arrays, with and without a
row mask and with tied scores (float32 sums: rtol = atol = 1e-6)."""

import numpy as np
import pytest
import torch
from torch_parity import t

from embracenet_tpu.ops import metrics as jm
from embracenet_tpu.training.results import baseline_auprc as j_baseline
from embracenet_tpu_torch.ops import metrics as tm
from embracenet_tpu_torch.training.results import baseline_auprc as t_baseline


@pytest.fixture(params=["plain", "masked", "no_positives"])
def case(request, rng):
    n = 64
    y = (rng.random(n) < 0.35).astype(np.int32)
    if request.param == "no_positives":
        y[:] = 0
    logits = rng.normal(size=(n, 2)).astype(np.float32)
    # ties: scores on a coarse grid
    scores = np.round(rng.random(n) * 8).astype(np.float32) / 8
    mask = (rng.random(n) < 0.8).astype(np.float32) \
        if request.param == "masked" else None
    return logits, scores, y, mask


@pytest.mark.parametrize("name", ["auprc_argmax", "f1_precision_recall",
                                  "accuracy"])
def test_logit_metrics(case, name):
    logits, _, y, mask = case
    want = getattr(jm, name)(logits, y, mask)
    got = getattr(tm, name)(t(logits), t(y), None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["auprc_prob", "auroc"])
def test_score_metrics(case, name):
    _, scores, y, mask = case
    want = getattr(jm, name)(scores, y, mask)
    got = getattr(tm, name)(t(scores), t(y), None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_baseline_auprc():
    for y in ([0, 1, 1, 0], [0] * 20 + [1]):
        assert t_baseline(y) == j_baseline(y)
    assert isinstance(t_baseline(torch.tensor([0, 1]).numpy()), float)
