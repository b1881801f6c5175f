"""Tests of the port that need the CUDA card: the fused embrace kernels
against their plain version, the fused op's gradient on the card against
the CPU, serving on the card against serving on the CPU, and a fit on the
card.  They skip without a card.  This file imports neither JAX nor the
JAX package, so the machine with the card runs it on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 rtol = atol = 1e-4 (the K-sum taken in another order);
bf16 operands against the plain version on the same bf16 operands, 1e-2.
"""

import traceback
import warnings

import numpy as np
import pytest
import torch

from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models import embracenet
from embracenet_tpu_torch.models.reload import ReloadedModel
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.modelspec import get_spec


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, dtype, b=100, d0=200, d1=600, e=384, live=256):
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    x0, x1 = torch.relu(randn(b, d0)).to(dtype), torch.relu(randn(b, d1)).to(dtype)
    w0 = (randn(d0, e + 64) * d0 ** -0.5).to(dtype)[:, :e]
    w1 = (randn(d1, e + 64) * d1 ** -0.5).to(dtype)[:, :e]
    b0, b1 = randn(e) * 0.1, randn(e) * 0.1
    e_mask = (torch.arange(e, device=dev) < live).float()
    return x0, x1, w0, b0, w1, b1, e_mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, dtype)
    b, e = x0.shape[0], w0.shape[1]
    args = (x0, x1, w0, b0, w1, b1)
    ones, zeros = torch.ones(b, device=cuda), torch.zeros(b, device=cuda)
    u = torch.zeros(b, e, device=cuda)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u)
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, u)
    p0 = torch.linspace(0, 1, b, device=cuda)
    before = K.LAUNCHES
    out, choose = K.fused_embrace(*args, p0, e_mask, 7)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    assert choose.dtype == torch.uint8
    torch.testing.assert_close(out, torch.where(choose.bool(), d0, d1),
                               rtol=tol, atol=tol)
    assert bool((out[:, 256:] == 0).all())
    assert bool((choose[0] == 0).all()) and bool((choose[-1] == 1).all())
    again, _ = K.fused_embrace(*args, p0, e_mask, 7)
    assert torch.equal(out, again)


def test_cuda_tensor_never_falls_back(cuda):
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, torch.float32)
    p0 = torch.full((x0.shape[0],), 0.5, device=cuda)
    with pytest.raises(TypeError):
        K.fused_embrace(x0.half(), x1.half(), w0.half(), b0, w1.half(), b1,
                        p0, e_mask, 0)


def test_serving_on_the_card_matches_the_cpu(cuda):
    flat = {"FFNN_n_layers": 2, "FFNN_n_units_l0": 64, "FFNN_n_units_l1": 32,
            "CNN_n_layers": 2, "CNN_out_channels_l0": 32,
            "CNN_out_channels_l1": 64, "CNN_kernel_size_l0": 11,
            "CNN_kernel_size_l1": 15, "EMBRACENET_embracement_size": 768,
            "n_post_layers": 1, "EMBRACENET_n_units_l0": 128,
            "selection_probabilities_FFNN": 1.0}
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, 16)
    rng = np.random.default_rng(0)
    data = {"ffnn": rng.normal(size=(300, 16)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(300, 256), dtype=np.uint8)}
    want = ReloadedModel("EmbraceNetMultimodal", params, bn, flat,
                         in_features_ffnn=16, device="cpu")(data, logits=True)
    before = K.LAUNCHES
    got = ReloadedModel("EmbraceNetMultimodal", params, bn, flat,
                        in_features_ffnn=16)(data, logits=True)
    assert K.LAUNCHES == before + 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gradients_on_the_card_equal_the_cpu_for_the_same_choose(cuda):
    """The Function's backward on the card against its backward on the CPU,
    given the card's own choose (the CPU draws another stream)."""
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, torch.float32)
    b, e = x0.shape[0], w0.shape[1]
    g = torch.randn(b, e, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in (x0, x1, w0, b0, w1, b1)]
    out, choose = K.fused_embrace(*leaves, torch.full((b,), 0.5, device=cuda),
                                  e_mask, 3)
    got = torch.autograd.grad((out * g).sum(), leaves)
    cpu = [a.detach().cpu() for a in (x0, x1, w0, w1)]
    want = K.embrace_backward(g.cpu(), *cpu[:2], cpu[2], cpu[3], e_mask.cpu(),
                              choose.cpu(), out.detach().cpu())
    for g_card, g_cpu in zip(got, want):   # dx0, dx1, dw0, db0, dw1, db1
        torch.testing.assert_close(g_card.cpu(), g_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fulle_chooses_as_fused_for_the_same_seed(cuda, dtype):
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, dtype)
    p0 = torch.linspace(0, 1, x0.shape[0], device=cuda)
    before = K.LAUNCHES_FULLE
    out_f, ch_f = K.fused_embrace_fulle(x0, x1, w0, b0, w1, b1, p0, e_mask, 21)
    out_t, ch_t = K.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 21)
    torch.cuda.synchronize()
    assert K.LAUNCHES_FULLE == before + 1
    assert torch.equal(ch_f, ch_t)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out_f, out_t, rtol=tol, atol=tol)


def _fit_inputs():
    rng = np.random.default_rng(0)
    n, d = 400, 16
    y = (rng.random(n) < 0.3).astype(np.int64)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, rng.normal(size=d))
         ).astype(np.float32)
    data = {"ffnn": x, "cnn": rng.integers(0, 4, size=(n, 256), dtype=np.uint8),
            "y": y}
    train = {k: v[:300] for k, v in data.items()}
    test = {k: v[300:] for k, v in data.items()}
    flat = {"FFNN_n_layers": 2, "FFNN_n_units_l0": 64, "FFNN_n_units_l1": 32,
            "CNN_n_layers": 1, "CNN_out_channels_l0": 32, "CNN_kernel_size_l0": 11,
            "EMBRACENET_embracement_size": 512, "n_post_layers": 1,
            "EMBRACENET_n_units_l0": 64, "selection_probabilities_FFNN": 0.5,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    return (get_spec("EmbraceNetMultimodal", d),
            [space.params_to_hp("EmbraceNetMultimodal", flat)],
            [space.optimizer_hp(flat)], train, test)


def test_fit_runs_on_the_card_through_the_kernel(cuda):
    before = K.LAUNCHES
    res = engine.fit(*_fit_inputs(),
                     TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=100))
    # 4 train batches (n_batches + 1) and 1 eval batch per epoch
    assert K.LAUNCHES - before == 2 * (4 + 1)
    assert res.epochs_run == [2]
    assert all(np.isfinite(res.loss_train[0] + res.auprc_test[0]))
    assert res.params["dock1_w"].device.type == "cuda"


def test_fit_never_waits_for_the_card_inside_a_chunk(cuda):
    """With CUDA's sync debug mode on, the only waits are set-up copies and
    the metric fetch after each chunk: none comes from inside a chunk."""
    waits = []

    def record(*_args, **_kw):
        waits.append([f.name for f in traceback.extract_stack()])

    cfg = TrainConfig(num_epochs=4, epoch_chunk=2, batch_size=100,
                      eval_reshuffle=True, pipeline_chunks=True)
    engine.fit(*_fit_inputs(), cfg)   # warm-up: cuDNN and the kernel build
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.fit(*_fit_inputs(), cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert any("_process" in w for w in waits)   # the per-chunk fetch
    assert not [w for w in waits if "run_chunk" in w]
