"""Port layers, codec and config copies vs the JAX package (CPU, float32:
rtol = atol = 1e-5 — the same arithmetic, summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
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
from embracenet_tpu_torch.utils.profiling import counters

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


def _conv_gemm_inputs(rng, n_trials, k, c=32, o=8, length=40):
    # weights at the scale of the layer's init (fan-in C*K), outputs ~1
    x = rng.normal(size=(3, n_trials * c, length)).astype(np.float32)
    w = (rng.normal(size=(n_trials, o, c, k)) / np.sqrt(c * k)).astype(
        np.float32)
    g = rng.normal(size=(3, n_trials * o, length)).astype(np.float32)
    return x, w, g


def _conv_gemm(x, w, g):
    """conv1d_trials inside population_invariant (so a lone trial too takes
    the GEMM path) -> (y, dx, dw)."""
    xs, ws = t(x).requires_grad_(True), t(w).requires_grad_(True)
    with tl.population_invariant():
        y = tl.conv1d_trials(xs, ws)
        return (y,) + torch.autograd.grad(y, (xs, ws), t(g))


@pytest.mark.parametrize("n_trials", [1, 3])
@pytest.mark.parametrize("k", [5, 11, 15])
def test_conv1d_trials_gemm_path_is_each_trials_jax_conv(rng, k, n_trials):
    # a float32 population's convolutions (windows at least
    # _GEMM_MIN_DEPTH = 128 deep: 32 channels x 5 taps and up) run as
    # per-trial GEMMs over im2col windows, counted by conv.gemm
    c, o = 32, 8
    x, w, g = _conv_gemm_inputs(rng, n_trials, k, c, o)
    before = counters().get("conv.gemm", 0)
    y, _, _ = _conv_gemm(x, w, g)
    assert counters()["conv.gemm"] == before + 1
    for i in range(n_trials):
        close(y[:, i * o:(i + 1) * o],
              jl.conv1d_ncw(x[:, i * c:(i + 1) * c], w[i]), TOL)


@pytest.mark.parametrize("n_trials", [1, 3])
@pytest.mark.parametrize("k", [5, 11, 15])
def test_conv1d_trials_gemm_gradients_are_conv1d_autograds(rng, k, n_trials):
    x, w, g = _conv_gemm_inputs(rng, n_trials, k)
    _, dx, dw = _conv_gemm(x, w, g)
    xs, ws = t(x).requires_grad_(True), t(w).requires_grad_(True)
    y = F.conv1d(xs, ws.reshape(-1, *ws.shape[2:]), padding=(k - 1) // 2,
                 groups=n_trials)
    want_dx, want_dw = torch.autograd.grad(y, (xs, ws), t(g))
    close(dx, want_dx, TOL)
    close(dw, want_dw, TOL)


@pytest.mark.parametrize("k", [5, 15])
def test_conv1d_trials_lone_trial_sums_as_in_a_population(rng, k):
    # inside population_invariant a lone trial's products run as one of
    # two: its forward and both gradients are trial 0's of 3, bit for bit
    x, w, g = _conv_gemm_inputs(rng, 3, k)
    one = _conv_gemm(x[:, :32], w[:1], g[:, :8])
    three = _conv_gemm(x, w, g)
    for a, b, n in zip(one, three, (8, 32, 1)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b[:n].detach().numpy() if b.dim() == 4
                                      else b[:, :n].detach().numpy())


def test_conv_gemm_counts_population_fits_not_serving_or_bf16(rng):
    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.models import embracenet
    from embracenet_tpu_torch.models.reload import ReloadedModel
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.modelspec import get_spec

    d = 8
    data = {"ffnn": rng.normal(size=(250, d)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(250, 256), dtype=np.uint8),
            "y": (rng.random(250) < 0.3).astype(np.int64)}
    train = {k: v[:200] for k, v in data.items()}
    test = {k: v[200:] for k, v in data.items()}
    flats = [{"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "CNN_n_layers": n,
              "CNN_out_channels_l0": 16, "CNN_kernel_size_l0": 5,
              "CNN_out_channels_l1": 32, "CNN_kernel_size_l1": 11,
              "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
              "selection_probabilities_FFNN": 0.5, "optimizer": "Adam",
              "lr": 1e-3, "weight_decay": 1e-4} for n in (1, 2)]
    spec = get_spec("EmbraceNetMultimodal", d)
    hps = [tspace.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    before = counters()
    engine.fit(spec, hps, [tspace.optimizer_hp(f) for f in flats], train, test,
               TrainConfig(num_epochs=2, batch_size=100), device="cpu")
    after = counters()
    steps = after["engine.train_steps"] - before.get("engine.train_steps", 0)
    # the second block (16 channels x 11 taps) in every train step and in
    # each epoch's one evaluation batch; the first (4 x 5) stays on cuDNN
    assert after["conv.gemm"] - before.get("conv.gemm", 0) == steps + 2

    # one model served, and a bf16 population: cuDNN, not counted
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hps[1], d)
    model = ReloadedModel("EmbraceNetMultimodal", params, bn, flats[1],
                          in_features_ffnn=d, device="cpu")
    before = counters().get("conv.gemm", 0)
    assert model(test).shape[0] == 50
    x, w, _ = _conv_gemm_inputs(rng, 3, 5)
    tl.conv1d_trials(t(x), t(w), "bfloat16")
    assert counters().get("conv.gemm", 0) == before


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


#: JAX config fields the port leaves out (ROADMAP Queue 3, "Compiled-program
#: reuse"; allow-listed in tests/test_torch_surface.py)
CONFIG_LEFT_OUT = {("TrainConfig", "cnn_full_depth"),
                   ("TrainConfig", "pad_ffnn_features"),
                   ("CVConfig", "share_programs")}


def test_config_copies_equal():
    for name in dir(jconfig):
        if name.isupper():
            assert getattr(tconfig, name) == getattr(jconfig, name), name
    for cls in ("TrainConfig", "CVConfig", "MeshConfig", "ExperimentConfig"):
        j, p = getattr(jconfig, cls), getattr(tconfig, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(j)
                if (cls, f.name) not in CONFIG_LEFT_OUT] == \
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
