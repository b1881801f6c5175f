"""The fused embrace op's gradient and the full-E forward against the JAX
package.

The JAX kernels run in the Pallas TPU interpreter (float32 operands, the
TPU PRNG stubbed to zeros, as ``tests/test_pallas_embrace.py`` runs them),
so the draw is exact only at p0 in {0, 1}; there the Function's gradients
must equal ``jax.grad`` through the JAX custom VJP within rtol = atol =
2e-4, the tolerance of ``tests/test_pallas_embrace.py:102-107``.  At a mid
p0 the Function is held to torch autograd of ``where(choose, d0, d1) *
e_mask`` given its own ``choose``.  On the CPU the Function's forward is
the kernel's plain version; the backward is the one the card runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import close, t

from embracenet_tpu.ops.pallas.embrace import _fused_fwd_fulle
from embracenet_tpu.ops.pallas.embrace import fused_embrace as j_fused
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.utils.profiling import counters

TOL = 2e-4


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
    g = rng.normal(size=(b, e)).astype(np.float32)
    return (x0, x1, w0, b0, w1, b1), e_mask, g


def _torch_grads(args, p0, e_mask, g, seed=3):
    leaves = [t(a).requires_grad_(True) for a in args]
    out, choose = K.fused_embrace(*leaves, t(p0), t(e_mask), seed)
    assert out.grad_fn is not None and not choose.requires_grad
    grads = torch.autograd.grad((out * t(g)).sum(), leaves)
    return out, choose, grads


@pytest.mark.parametrize("p0_value", [0.0, 1.0])
def test_gradients_match_jax_custom_vjp(inputs, p0_value):
    args, e_mask, g = inputs
    p0 = np.full(len(args[0]), p0_value, np.float32)

    @jax.jit
    def j_grads(*a):
        def loss(*a):
            return jnp.sum(j_fused(*a, p0, e_mask, 3, interpret=True) * g)
        return jax.grad(loss, argnums=tuple(range(6)))(*a)

    want = j_grads(*args)
    _, choose, got = _torch_grads(args, p0, e_mask, g)
    assert bool((choose == int(p0_value)).all())
    for name, gt, gj in zip(("dx0", "dx1", "dw0", "db0", "dw1", "db1"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_mid_probability_gradients_follow_the_choice(inputs):
    args, e_mask, g = inputs
    p0 = np.linspace(0, 1, len(args[0])).astype(np.float32)
    _, choose, got = _torch_grads(args, p0, e_mask, g)
    assert 0 < float(choose.float().mean()) < 1
    leaves = [t(a).requires_grad_(True) for a in args]
    x0, x1, w0, b0, w1, b1 = leaves
    d0 = torch.relu(x0 @ w0 + b0)
    d1 = torch.relu(x1 @ w1 + b1)
    out = torch.where(choose.bool(), d0, d1) * t(e_mask)
    want = torch.autograd.grad((out * t(g)).sum(), leaves)
    for gt, gw in zip(got, want):
        close(gt, gw.numpy(), TOL)


def test_gradient_lands_in_the_viewed_slice(inputs):
    (x0, x1, w0, b0, w1, b1), e_mask, g = inputs
    d0, e = w0.shape
    base0 = torch.zeros(d0 + 8, e + 64).requires_grad_(True)
    base1 = torch.zeros(w1.shape[0] + 8, e + 64).requires_grad_(True)
    with torch.no_grad():
        base0[:d0, :e] = t(w0)
        base1[:w1.shape[0], :e] = t(w1)
    p0 = torch.full((len(x0),), 0.5)
    out, _ = K.fused_embrace(t(x0), t(x1), base0[:d0, :e], t(b0),
                             base1[:w1.shape[0], :e], t(b1), p0, t(e_mask), 9)
    (out * t(g)).sum().backward()
    _, _, (_, _, dw0, _, dw1, _) = _torch_grads(
        (x0, x1, w0, b0, w1, b1), p0.numpy(), e_mask, g, seed=9)
    close(base0.grad[:d0, :e], dw0.numpy(), 0)
    close(base1.grad[:w1.shape[0], :e], dw1.numpy(), 0)
    assert float(base0.grad[d0:].abs().sum() + base0.grad[:, e:].abs().sum()) == 0.0


def test_bf16_operands_get_bf16_gradients(inputs):
    args, e_mask, g = inputs
    leaves = [t(a).requires_grad_(True) for a in args]
    cast = [a.bfloat16() if i in (0, 1, 2, 4) else a for i, a in enumerate(leaves)]
    out, _ = K.fused_embrace(*cast, torch.full((len(args[0]),), 0.5), t(e_mask), 2)
    grads = torch.autograd.grad((out * t(g)).sum(), cast)
    assert [gr.dtype for gr in grads] == [torch.bfloat16] * 3 + [torch.float32,
                                                                  torch.bfloat16,
                                                                  torch.float32]


@pytest.mark.parametrize("p0_value", [0.0, 1.0])
def test_fulle_plain_version_matches_pallas_interpret(inputs, p0_value):
    args, e_mask, _ = inputs
    p0 = np.full(len(args[0]), p0_value, np.float32)
    out_j, choose_j = _fused_fwd_fulle(*args, p0, e_mask, 3, interpret=True)
    out_t, choose_t = K.fused_embrace_fulle(*map(t, args), t(p0), t(e_mask), 3)
    close(out_t, out_j, 1e-5)
    np.testing.assert_array_equal(choose_t.numpy(), np.asarray(choose_j))


def test_fulle_chooses_as_fused_and_counts_no_cpu_launch(inputs):
    args, e_mask, _ = inputs
    p0 = torch.linspace(0, 1, len(args[0]))
    before = counters().get("embrace.launches_fulle", 0)
    out_f, ch_f = K.fused_embrace_fulle(*map(t, args), p0, t(e_mask), 11)
    out_t, ch_t = K.fused_embrace(*map(t, args), p0, t(e_mask), 11)
    assert counters().get("embrace.launches_fulle", 0) == before
    assert torch.equal(ch_f, ch_t) and torch.equal(out_f, out_t)


def test_fulle_is_forward_only(inputs):
    args, e_mask, _ = inputs
    leaves = [t(a).requires_grad_(True) for a in args]
    p0 = torch.full((len(args[0]),), 0.5)
    with pytest.raises(RuntimeError, match="forward only"):
        K.fused_embrace_fulle(*leaves, p0, t(e_mask), 1)
    with torch.no_grad():
        out, _ = K.fused_embrace_fulle(*leaves, p0, t(e_mask), 1)
    assert out.shape == (len(args[0]), len(e_mask))


def test_tensor_seed_draws_as_the_int_seed(inputs):
    args, e_mask, _ = inputs
    p0 = torch.full((len(args[0]),), 0.5)
    a = K.fused_embrace(*map(t, args), p0, t(e_mask), 1234)[1]
    b = K.fused_embrace(*map(t, args), p0, t(e_mask), torch.tensor(1234))[1]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="0-d int64"):
        K.fused_embrace(*map(t, args), p0, t(e_mask), torch.tensor([1234]))
