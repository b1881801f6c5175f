"""Tests of the port that need the CUDA card: the fused embrace kernel
against its plain version, and serving on the card against serving on the
CPU.  They skip without a card.  This file imports neither JAX nor the
JAX package, so the machine with the card runs it on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 rtol = atol = 1e-4 (the K-sum taken in another order);
bf16 operands against the plain version on the same bf16 operands, 1e-2.
"""

import numpy as np
import pytest
import torch

from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models import embracenet
from embracenet_tpu_torch.models.reload import ReloadedModel
from embracenet_tpu_torch.ops import embrace as K


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
