"""The fused embrace op's plain version and CPU wrapper vs the JAX package.

The JAX kernel runs in the Pallas TPU interpreter, which computes in float32
and stubs the TPU PRNG to zeros (``tests/test_pallas_embrace.py``), so the
JAX side picks modality 0 wherever p0 > 0.  Feeding the plain version
``u = 0`` makes that draw exact; at p0 in {0, 1} any draw is exact.
Tolerance rtol = atol = 1e-5: the same float32 products summed in another
order.  The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import close, t

from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.ops.pallas.embrace import _fused_fwd_raw
from embracenet_tpu_torch.models import embracenet as tem
from embracenet_tpu_torch.ops import embrace as tops
from embracenet_tpu_torch.utils.profiling import counters

TOL = 1e-5


@pytest.fixture
def inputs(rng):
    b, d0, d1, e = 24, 32, 160, 256
    x0 = rng.normal(size=(b, d0)).astype(np.float32)
    x1 = rng.normal(size=(b, d1)).astype(np.float32)
    w0 = rng.normal(size=(d0, e)).astype(np.float32) * 0.1
    b0 = rng.normal(size=(e,)).astype(np.float32) * 0.1
    w1 = rng.normal(size=(d1, e)).astype(np.float32) * 0.1
    b1 = rng.normal(size=(e,)).astype(np.float32) * 0.1
    e_mask = (np.arange(e) < 192).astype(np.float32)
    return x0, x1, w0, b0, w1, b1, e_mask


@pytest.mark.parametrize("p0_value,u_value", [(1.0, 0.5), (0.0, 0.5),
                                              (0.3, 0.0)])
def test_reference_matches_pallas_interpret(inputs, p0_value, u_value):
    x0, x1, w0, b0, w1, b1, e_mask = inputs
    p0 = np.full(len(x0), p0_value, np.float32)
    out_j, choose_j = _fused_fwd_raw(x0, x1, w0, b0, w1, b1, p0, e_mask, 3,
                                     interpret=True)
    u = torch.full((len(x0), w0.shape[1]), u_value)
    out_t, choose_t = tops.fused_embrace_reference(
        *map(t, (x0, x1, w0, b0, w1, b1, p0, e_mask)), u)
    close(out_t, out_j, TOL)
    assert choose_t.dtype == torch.uint8
    np.testing.assert_array_equal(choose_t.numpy(), np.asarray(choose_j))


def test_cpu_wrapper_is_reference_and_counts_no_launch(inputs):
    x0, x1, w0, b0, w1, b1, e_mask = map(t, inputs)
    p0 = torch.linspace(0, 1, len(x0))
    before = counters().get("embrace.launches", 0)
    out, choose = tops.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 11)
    assert counters().get("embrace.launches", 0) == before
    # uniforms at the live width of e_mask (its 192 kept columns), zeros past
    u = torch.zeros((len(x0), w0.shape[1]))
    u[:, :192] = torch.rand((len(x0), 192),
                            generator=torch.Generator().manual_seed(11))
    want, want_choose = tops.fused_embrace_reference(
        x0, x1, w0, b0, w1, b1, p0, e_mask, u)
    close(out, want, 0)
    assert torch.equal(choose, want_choose)
    # the same seed gives the same draw, another seed another one
    again, _ = tops.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 11)
    other, _ = tops.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 12)
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_wrapper_takes_row_strided_weights(inputs):
    x0, x1, w0, b0, w1, b1, e_mask = map(t, inputs)
    p0 = torch.full((len(x0),), 0.5)
    # views w[:D, :E] of wider weights, as the model's bucket slices are
    w0v = torch.cat([w0, torch.ones_like(w0)], 1)[:, :w0.shape[1]]
    w1v = torch.cat([w1, torch.ones_like(w1)], 1)[:, :w1.shape[1]]
    assert not w0v.is_contiguous()
    a, _ = tops.fused_embrace(x0, x1, w0v, b0, w1v, b1, p0, e_mask, 5)
    b, _ = tops.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 5)
    close(a, b, 0)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "stride"])
def test_wrapper_rejects_bad_inputs(inputs, bad):
    x0, x1, w0, b0, w1, b1, e_mask = map(t, inputs)
    p0 = torch.full((len(x0),), 0.5)
    if bad == "shape":
        w1 = w1[:-1]
    elif bad == "dtype":
        x0, x1, w0, w1 = (a.double() for a in (x0, x1, w0, w1))
    elif bad == "mixed":
        w1 = w1.bfloat16()
    else:
        w1 = w1.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        tops.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 0)


def test_unfused_embrace_with_jax_uniforms(rng):
    b, width = 12, 768
    d0 = rng.normal(size=(b, width)).astype(np.float32)
    d1 = rng.normal(size=(b, width)).astype(np.float32)
    e_mask = (np.arange(width) < 512).astype(np.float32)
    p = np.full((b, 2), 0.5, np.float32)
    key = jax.random.PRNGKey(4)
    want = jem.embrace([d0, d1], key, selection_probabilities=p, e_mask=e_mask)
    u = np.asarray(jax.random.uniform(key, (b, tem.E)))
    got = tem.embrace([t(d0), t(d1)], selection_probabilities=t(p),
                      e_mask=t(e_mask), u=t(u))
    close(got, want, 0)


def test_embrace_three_modalities_follows_probabilities(rng):
    docks = [torch.full((4, 32), float(i + 1)) for i in range(3)]
    p = torch.tensor([[0, 1, 0], [0, 0, 1], [1, 0, 0], [0, 1, 0]],
                     dtype=torch.float32)
    out = tem.embrace(docks, torch.Generator().manual_seed(0),
                      selection_probabilities=p)
    close(out, np.repeat([[2.0], [3.0], [1.0], [2.0]], 32, axis=1), 0)
