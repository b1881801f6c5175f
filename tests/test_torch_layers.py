"""Port layers, codec and config copies vs the JAX package (CPU, float32:
rtol = atol = 1e-5 — the same arithmetic, summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import close, t

from embracenet_tpu import config as jconfig
from embracenet_tpu.data import codec as jcodec
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import layers as jl
from embracenet_tpu.ops import convmath as jconv
from embracenet_tpu.ops.optim import OPTIMIZER_IDS
from embracenet_tpu_torch import config as tconfig
from embracenet_tpu_torch.data import codec as tcodec
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.models import layers as tl
from embracenet_tpu_torch.ops import convmath as tconv

TOL = 1e-5


@pytest.mark.parametrize("compute_dtype", [None, "float32", "bfloat16"])
def test_linear(rng, compute_dtype):
    # "float32" (TrainConfig's default name) is the full float32 path
    x = rng.normal(size=(9, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jl.linear(x, w, b,
                     jnp.bfloat16 if compute_dtype == "bfloat16" else None)
    close(tl.linear(t(x), t(w), t(b), compute_dtype), want, TOL)


@pytest.mark.parametrize("k", [5, 11, 15])
def test_conv1d_ncw(rng, k):
    x = rng.normal(size=(3, 6, 40)).astype(np.float32)
    w = rng.normal(size=(8, 6, k)).astype(np.float32)
    close(tl.conv1d_ncw(t(x), t(w)), jl.conv1d_ncw(x, w), TOL)


def test_conv1d_ncw_bf16_runs_in_bf16(rng):
    # bf16 throughout, upcast after: both sides round the result to bf16
    # (8-bit mantissa), so they agree to one bf16 step, not to f32
    x = rng.normal(size=(3, 6, 40)).astype(np.float32)
    w = rng.normal(size=(8, 6, 11)).astype(np.float32)
    got = tl.conv1d_ncw(t(x), t(w), "bfloat16")
    assert got.dtype == torch.float32
    close(got, jl.conv1d_ncw(x, w, jnp.bfloat16), 3e-2)


def test_maxpool1d(rng):
    x = rng.normal(size=(2, 5, 124)).astype(np.float32)
    close(tl.maxpool1d(t(x)), jl.maxpool1d(x), 0)


def _bn(rng, c):
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_apply(rng, train):
    c = 6
    x = rng.normal(size=(5, c, 20)).astype(np.float32)
    params, state = _bn(rng, c)
    row_mask = np.asarray([1, 1, 0, 1, 0], np.float32)
    y_j, s_j = jl.batchnorm_apply(x, params, state, train, row_mask)
    y_t, s_t = tl.batchnorm_apply(
        t(x), {k: t(v) for k, v in params.items()},
        {k: t(v) for k, v in state.items()}, train, t(row_mask))
    close(y_t, y_j, TOL)
    for k in ("mean", "var"):
        close(s_t[k], s_j[k], TOL)


def test_batchnorm_init():
    p_j, s_j = jl.batchnorm_init(7)
    p_t, s_t = tl.batchnorm_init(7)
    for a, b in ((p_j, p_t), (s_j, s_t)):
        for k in a:
            close(b[k], a[k], 0)


@pytest.mark.parametrize("width", [0, 5, 16])
def test_width_mask(width):
    close(tl.width_mask(16, width), jl.width_mask(16, width), 0)


@pytest.mark.parametrize("kernel", [5, 11, 15])
def test_kernel_tap_mask(kernel):
    close(tl.kernel_tap_mask(15, kernel), jl.kernel_tap_mask(15, kernel), 0)


def test_dropout_train_and_eval():
    x = torch.ones((64, 128))
    assert tl.dropout(x, 0.4, None, False) is x
    gen = torch.Generator().manual_seed(0)
    y = tl.dropout(x, 0.4, gen, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.6) < 0.02
    close(y[kept], np.full(int(kept.sum()), 1 / 0.6, np.float32), 1e-6)


def test_torch_uniform_init_bounds():
    gen = torch.Generator().manual_seed(0)
    w = tl.torch_uniform_init(gen, (200, 50), 25)
    assert w.abs().max().item() <= 0.2
    assert w.abs().max().item() > 0.19


def test_one_hot_and_codec(rng):
    codes = rng.integers(0, 4, size=(3, 256)).astype(np.uint8)
    close(tcodec.one_hot(t(codes)), jcodec.one_hot(codes), 0)
    seqs = ["acgtn" * 4, "NNacgtTGCA" * 2]
    for native in (False, True):   # numpy's stream, the native xorshift
        np.testing.assert_array_equal(
            tcodec.encode_sequences(seqs, 3, native=native),
            jcodec.encode_sequences(seqs, 3, native=native))
    np.testing.assert_array_equal(tcodec.complement_codes(codes),
                                  jcodec.complement_codes(codes))


def test_config_copies_equal():
    for name in dir(jconfig):
        if name.isupper():
            assert getattr(tconfig, name) == getattr(jconfig, name), name
    for cls in ("TrainConfig", "CVConfig", "MeshConfig", "ExperimentConfig"):
        j, p = getattr(jconfig, cls), getattr(tconfig, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(j)] == \
               [(f.name, f.default) for f in dataclasses.fields(p)], cls
    assert tconv.CNN_LENGTHS == jconv.CNN_LENGTHS
    for depth in range(1, 5):
        assert tconv.output_size_from_params(depth, 96) == \
            jconv.output_size_from_params(depth, 96)
    assert tspace.OPTIMIZER_IDS == OPTIMIZER_IDS


@pytest.mark.parametrize("model", ["FFNN", "CNN", "EmbraceNetMultimodal",
                                   "ConcatNetMultimodal", "CNN_LSTM"])
def test_space_copy_equal(model):
    def described(space):
        return {k: (type(v).__name__, dataclasses.astuple(v))
                for k, v in space.items()}

    assert described(tspace.model_space(model)) == \
        described(jspace.model_space(model))
    flat_t = tspace.sample_params(model, np.random.default_rng(7))
    flat_j = jspace.sample_params(model, np.random.default_rng(7))
    assert flat_t == flat_j
    hp_t = tspace.params_to_hp(model, flat_t)
    hp_j = jspace.params_to_hp(model, flat_j)
    jax.tree.map(np.testing.assert_array_equal, hp_t, hp_j)
    assert jax.tree.map(lambda a: np.asarray(a).dtype, hp_t) == \
        jax.tree.map(lambda a: np.asarray(a).dtype, hp_j)
    assert tspace.optimizer_hp(flat_t) == jspace.optimizer_hp(flat_j)
