"""Tests of the port that need the CUDA card: the fused embrace kernels
against their plain version, the fused op's gradient on the card against
the CPU, serving on the card against serving on the CPU, a fit on the
card and a study's search, a 1 x 1 NCCL mesh, the kernels' row_base,
the checkpoint's second backend saving tensors on the card, the
program's spans on the device trace's clock, the float32 population
convolution's GEMM path (a trial's sums alike in any population, against
cuDNN's grouped convolution), CNN_LSTM's recurrence against cuDNN's
LSTM called directly, a population's initial parameters drawn by the
MT19937 kernel against the CPU generators' draws, bit for bit, and the
fused optimizer update against its plain version, bit for bit.
They skip without a card.  This file imports neither JAX nor the
JAX package, so the machine with the card runs it on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 rtol = atol = 1e-4 (the K-sum taken in another order);
bf16 operands against the plain version on the same bf16 operands, 1e-2.
"""

import contextlib
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
from embracenet_tpu_torch.utils import profiling


def _launches(name="embrace.launches"):
    """Launches of a fused kernel so far (``utils.profiling`` counter)."""
    return profiling.counters().get(name, 0)


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
    before = _launches()
    out, choose = K.fused_embrace(*args, p0, e_mask, 7)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert choose.dtype == torch.uint8
    torch.testing.assert_close(out, torch.where(choose.bool(), d0, d1),
                               rtol=tol, atol=tol)
    assert bool((out[:, 256:] == 0).all())
    assert bool((choose[0] == 0).all()) and bool((choose[-1] == 1).all())
    again, _ = K.fused_embrace(*args, p0, e_mask, 7)
    assert torch.equal(out, again)


# edge shapes of the tiled kernel (B around its 64-row tile, x0 rows of 8
# bytes in bf16, ragged K) and the main path's (training, evaluation,
# engine_bench's batches of 800 and 2048 and a batch of 1024 on unsplit
# 64-row tiles, serving)
TILED_SHAPES = [(1, 4, 1024, 512), (63, 16, 3200, 768), (65, 64, 1000, 768),
                (100, 256, 7936, 1024), (200, 256, 7936, 1024),
                (800, 256, 7936, 1024), (1024, 256, 7936, 1024),
                (2048, 256, 7936, 1024), (4096, 256, 7936, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d0,d1,e", TILED_SHAPES)
def test_tiled_kernel_at_edge_and_path_shapes(cuda, b, d0, d1, e, dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, dtype, b, d0, d1, e, e - 64)
    assert w1.stride(0) == e + 64                 # row-strided weight views
    args = (x0, x1, w0, b0, w1, b1)
    ones, zeros = torch.ones(b, device=cuda), torch.zeros(b, device=cuda)
    u = torch.zeros(b, e, device=cuda)
    d0_ref, _ = K.fused_embrace_reference(*args, ones, e_mask, u)
    d1_ref, _ = K.fused_embrace_reference(*args, zeros, e_mask, u)
    p0 = (torch.linspace(0, 1, b, device=cuda) if b > 1
          else torch.full((1,), 0.5, device=cuda))
    before = _launches()
    out, choose = K.fused_embrace(*args, p0, e_mask, 7)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    torch.testing.assert_close(out, torch.where(choose.bool(), d0_ref, d1_ref),
                               rtol=tol, atol=tol)
    assert bool((out[:, e - 64:] == 0).all())
    again, choose_again = K.fused_embrace(*args, p0, e_mask, 7)
    assert torch.equal(out, again) and torch.equal(choose, choose_again)
    on_card, choose_on_card = K.fused_embrace(
        *args, p0, e_mask, torch.tensor(7, device=cuda))
    assert torch.equal(out, on_card) and torch.equal(choose, choose_on_card)
    _, choose_fulle = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    assert torch.equal(choose, choose_fulle)


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
    before = _launches()
    got = ReloadedModel("EmbraceNetMultimodal", params, bn, flat,
                        in_features_ffnn=16)(data, logits=True)
    assert _launches() == before + 1
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
@pytest.mark.parametrize("b,d0,d1,e", TILED_SHAPES + [(100, 200, 600, 384)])
def test_fulle_chooses_as_fused_for_the_same_seed(cuda, b, d0, d1, e, dtype):
    """Same choose bit for bit; same out bit for bit where both kernels run
    the same tiles in the same K order (same tile rows, no split K), else
    within rounding.  E = 384 takes a cluster of 3, E = 768 one of 6."""
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, dtype, b, d0, d1, e, e - 64)
    p0 = (torch.linspace(0, 1, b, device=cuda) if b > 1
          else torch.full((1,), 0.5, device=cuda))
    before = _launches("embrace.launches_fulle")
    out_f, ch_f = K.fused_embrace_fulle(x0, x1, w0, b0, w1, b1, p0, e_mask, 21)
    out_t, ch_t = K.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 21)
    torch.cuda.synchronize()
    assert _launches("embrace.launches_fulle") == before + 1
    assert torch.equal(ch_f, ch_t)
    assert bool((out_f[:, e - 64:] == 0).all())
    index = torch.cuda.current_device()
    tiled = K.card_plan(b, e, d0, d1, dtype, index)
    if K.card_fulle_plan(b, e, d0, d1, dtype, index).bm == tiled.bm and tiled.split == 1:
        assert torch.equal(out_f, out_t)
    else:
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
    before = _launches()
    res = engine.fit(*_fit_inputs(),
                     TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=100))
    # 4 train batches (n_batches + 1) and 1 eval batch per epoch
    assert _launches() - before == 2 * (4 + 1)
    assert res.epochs_run == [2]
    assert all(np.isfinite(res.loss_train[0] + res.auprc_test[0]))
    assert res.params["dock1_w"].device.type == "cuda"


def test_a_one_by_one_nccl_mesh_fit_equals_the_meshless_fit(cuda):
    """``init_distributed`` with NCCL in a world of one process, a 1 x 1
    mesh, and ``fit(mesh=...)`` (its results gathered through NCCL) equal
    to the meshless fit on the card, bit for bit."""
    import torch.distributed as dist

    from embracenet_tpu_torch.parallel.mesh import (free_port, init_distributed,
                                                    make_mesh)

    cfg = TrainConfig(num_epochs=2, epoch_chunk=1, batch_size=100)
    plain = engine.fit(*_fit_inputs(), cfg)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1, 1)
        assert mesh.device.type == "cuda" and mesh.group("data") is not None
        meshed = engine.fit(*_fit_inputs(), cfg, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert meshed.loss_train == plain.loss_train
    assert meshed.auprc_test == plain.auprc_test
    for k, v in plain.params.items():
        if not isinstance(v, dict):
            assert torch.equal(meshed.params[k], v), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fused_embrace", "fused_embrace_fulle"])
def test_row_base_draws_the_whole_launch_rows_on_the_card(cuda, kernel, dtype):
    """Launches on rows [r, r + b) with ``row_base=r`` choose exactly as the
    launch on the whole batch does for those rows; ``out`` within the
    tolerance (another launch plan may sum K in another order)."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    fn = getattr(K, kernel)
    x0, x1, w0, b0, w1, b1, e_mask = _inputs(cuda, dtype)
    p0 = torch.linspace(0, 1, x0.shape[0], device=cuda)
    out, choose = fn(x0, x1, w0, b0, w1, b1, p0, e_mask, 7)
    for lo, hi in ((0, 50), (50, 100), (37, 100), (99, 100)):
        o, c = fn(x0[lo:hi], x1[lo:hi], w0, b0, w1, b1, p0[lo:hi].contiguous(),
                  e_mask, 7, row_base=lo)
        assert torch.equal(c, choose[lo:hi])
        torch.testing.assert_close(o, out[lo:hi], rtol=tol, atol=tol)


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


def test_run_search_trains_its_trials_on_the_card(cuda, tmp_path):
    """A 3-trial study (the reference's count) through ``run_search`` on the
    card: its rows, finite values and the kernel's launches."""
    from embracenet_tpu_torch.hpo.samplers import ReplaySampler
    from embracenet_tpu_torch.hpo.search import run_search
    from embracenet_tpu_torch.hpo.study import Study

    spec, _, _, train, test = _fit_inputs()
    draw = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.0,
            "CNN_n_layers": 1, "CNN_out_channels_l0": 16,
            "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.0,
            "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
            "selection_probabilities_FFNN": 0.5,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    draws = [draw, dict(draw, lr=2e-3), dict(draw, optimizer="RMSprop")]
    before = _launches()
    res = run_search(spec, "EmbraceNetMultimodal", train, test, "s",
                     storage=str(tmp_path / "s.db"),
                     sampler=ReplaySampler(draws), n_trials=3,
                     train_cfg=TrainConfig(num_epochs=2, epoch_chunk=2,
                                           batch_size=100),
                     checkpoint_dir=str(tmp_path))
    # the 3 trials train as one population: one launch a forward pass
    assert _launches() - before == 2 * (4 + 1)
    study = Study("s", str(tmp_path / "s.db"))
    rows = study.trials
    study.close()
    assert [t.state for t in rows] == ["COMPLETE"] * 3
    assert [t.params for t in rows] == draws
    assert all(np.isfinite(t.value) and len(t.intermediate) == 2 for t in rows)
    assert res.n_complete == 3 and res.best_model is not None
    assert res.best_value == max(t.value for t in rows)


@pytest.mark.parametrize("model,flat", [
    ("CNN", {"n_layers": 2, "out_channels_l0": 32, "kernel_size_l0": 11,
             "out_channels_l1": 64, "kernel_size_l1": 5}),
    ("CNN_LSTM", {"n_layers": 2, "out_channels_l0": 32, "kernel_size_l0": 11,
                  "out_channels_l1": 64, "kernel_size_l1": 5,
                  "LSTM_hidden_layer_size": 64, "LSTM_n_layers": 2})])
def test_training_step_on_the_card_equals_the_cpu(cuda, monkeypatch, model,
                                                  flat):
    """``engine.train_step``'s loss and every gradient it hands the
    optimizer on the card equal the CPU's within 1e-4 of the leaf's largest
    gradient (float32 summed in another order; TF32 in the backward pass
    of cuDNN's convolutions or LSTM is ~10x further off).  CNN_LSTM's
    recurrence runs through cuDNN's LSTM.  Conv biases are left out: a
    BatchNorm follows each conv, so their gradient is 0 but for rounding."""
    from embracenet_tpu_torch.convert import tree_to_torch
    from embracenet_tpu_torch.ops import optim

    def named_leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from named_leaves(v, f"{prefix}{k}/")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from named_leaves(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], tree

    flat = dict(flat, optimizer="Adam", lr=1e-3, weight_decay=1e-4)
    spec = get_spec(model)
    hp = space.params_to_hp(model, flat)
    params, bn = spec.init(torch.Generator().manual_seed(0), hp)
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=(32, 256)).astype(np.uint8))
    y = torch.from_numpy((rng.random(32) < 0.4).astype(np.int64))
    seen = {}
    real = optim.apply_update

    def capture(p, grads, *args):
        seen["grads"] = {k: None if g is None else g.cpu()
                         for k, g in named_leaves(grads)}
        return real(p, grads, *args)

    monkeypatch.setattr(optim, "apply_update", capture)
    out = []
    for dev in ("cpu", cuda):
        p = tree_to_torch(params, dev)
        loss, logits, _, _, _ = engine.train_step(
            spec, p, tree_to_torch(bn, dev), optim.init_state(p), hp,
            space.optimizer_hp(flat), {"cnn": codes.to(dev)}, y.to(dev),
            torch.ones(32, device=dev), 0, None, spec.statics([hp]))
        out.append((float(loss), logits.cpu(), seen.pop("grads")))
    (l_cpu, z_cpu, g_cpu), (l_card, z_card, g_card) = out
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    torch.testing.assert_close(z_card, z_cpu, rtol=1e-4,
                               atol=1e-4 * float(z_cpu.abs().max()))
    assert {k: g is None for k, g in g_card.items()} == \
        {k: g is None for k, g in g_cpu.items()}
    for name, b in g_cpu.items():
        # None: a block beyond the trial's depth
        if b is not None and not name.startswith("conv_b"):
            torch.testing.assert_close(
                g_card[name], b, rtol=1e-4, atol=1e-4 * float(b.abs().max()),
                msg=lambda m, name=name: f"{name}: {m}")


def test_cnn_lstm_serves_a_large_batch_in_row_chunks(cuda, monkeypatch):
    """A batch that the LSTM takes in several row chunks gives the logits
    of one call."""
    from embracenet_tpu_torch.models import cnn_lstm

    flat = {"n_layers": 1, "out_channels_l0": 16, "kernel_size_l0": 5,
            "LSTM_hidden_layer_size": 32, "LSTM_n_layers": 2}
    from embracenet_tpu_torch.convert import tree_to_torch
    from embracenet_tpu_torch.data.codec import one_hot

    hp = space.params_to_hp("CNN_LSTM", flat)
    params, bn = tree_to_torch(cnn_lstm.init(torch.Generator().manual_seed(0),
                                             hp), cuda)
    codes = torch.randint(0, 4, (300, 256), device=cuda, dtype=torch.uint8)
    x = one_hot(codes)
    whole, _ = cnn_lstm.apply(params, bn, hp, x)
    monkeypatch.setattr(cnn_lstm, "LSTM_CHUNK", 64 * 496 * 4 * 32 * 2)
    chunked, _ = cnn_lstm.apply(params, bn, hp, x)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("profiled", [False, True])
def test_the_recurrence_on_the_card_is_the_library_calls_bit_for_bit(
        cuda, monkeypatch, profiled):
    """``lstm_apply`` in three row chunks, with and without a profiler
    recording its span and the library's backward op, against cuDNN's
    LSTM called directly on the same chunks: outputs and every gradient
    bit for bit, and its steps counted once."""
    from embracenet_tpu_torch.models import cnn_lstm
    from embracenet_tpu_torch.models.layers import exact_float32

    gen = torch.Generator().manual_seed(3)
    params = [{k: v.to(cuda).requires_grad_(True) for k, v in layer.items()}
              for layer in cnn_lstm._lstm_init(gen, 4, 64, 2)]
    x = torch.randn(30, 464, 4, device=cuda, requires_grad=True)
    monkeypatch.setattr(cnn_lstm, "LSTM_CHUNK", 10 * 464 * 4 * 64 * 2)
    leaves = [x] + [v for layer in params for v in layer.values()]
    profiling.reset_counters()
    prof = torch.profiler.profile() if profiled else contextlib.nullcontext()
    with prof, exact_float32():   # as engine.population_step takes it
        out = cnn_lstm.lstm_apply(params, x, train=True)
        got = torch.autograd.grad((out ** 2).sum(), leaves)
        torch.cuda.synchronize()
    assert profiling.counters()["cnn_lstm.lstm_steps"] == 464 * 2
    if profiled:
        names = {e.name for e in prof.events()}
        assert {"cnn_lstm.lstm", "aten::_cudnn_rnn_backward"} <= names
    flat = []
    for layer in params:
        flat += [layer["w_ih"].t().contiguous(), layer["w_hh"].t().contiguous(),
                 layer["b_ih"], layer["b_hh"]]
    with exact_float32():
        parts = [torch._VF.lstm(c, (c.new_zeros(2, 10, 64),) * 2, flat, True,
                                2, 0.0, True, False, True)[0]
                 for c in x.split(10)]
        direct = torch.cat(parts)
        want = torch.autograd.grad((direct ** 2).sum(), leaves)
    assert torch.equal(out, direct)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_train_from_a_pipeline_launches_the_kernel_on_the_card(cuda, tmp_path):
    import embracenet_tpu_torch as et
    from embracenet_tpu_torch.benchkit import write_raw_dataset
    from embracenet_tpu_torch.config import CVConfig

    root = str(tmp_path / "data")
    write_raw_dataset(root, 300, {"HEPG2": 40, "K562": 8})
    task = "active_P_vs_inactive_P"
    pipe = et.preprocess(task, root=root, cache_dir=str(tmp_path / "cache"))
    before = _launches()
    scores = et.train("EmbraceNetMultimodal", "HEPG2", task, pipeline=pipe,
                      cv_cfg=CVConfig(n_folds=2, n_trials=2),
                      train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1,
                                            batch_size=50),
                      storage=str(tmp_path / "s.db"),
                      checkpoint_dir=str(tmp_path / "models"))
    assert _launches() > before
    assert all(np.isfinite(scores["final_test_AUPRC_scores"]))


def test_compare_models_result_predicts_on_the_card_as_on_the_cpu(cuda,
                                                                  tmp_path):
    from embracenet_tpu_torch.training.checkpoint import save_checkpoint
    from embracenet_tpu_torch.training.cv import checkpoint_name
    from embracenet_tpu_torch.visual.report import CompareModelsResult

    for name, width in (("FFNN", 64), ("CNN", 32)):    # two FFNNs
        flat = {"n_layers": 2, "n_units_l0": width, "n_units_l1": 16}
        hp = space.params_to_hp("FFNN", flat)
        params, bn = get_spec("FFNN", 16).init(
            torch.Generator().manual_seed(width), hp)
        save_checkpoint(str(tmp_path / checkpoint_name("K562", name, "t", 0)),
                        {"params": params, "bn_state": bn},
                        {"model": "FFNN", "model_params": flat})
    rng = np.random.default_rng(0)
    data = {"ffnn": rng.normal(size=(300, 16)).astype(np.float32),
            "y": (rng.random(300) < 0.3).astype(np.int64)}
    card = CompareModelsResult(str(tmp_path), n_folds=1)
    cpu = CompareModelsResult(str(tmp_path), n_folds=1, device="cpu")
    for name in ("FFNN", "CNN"):
        np.testing.assert_allclose(
            card._predictions("K562", name, "t", 0, data),
            cpu._predictions("K562", name, "t", 0, data), rtol=1e-5, atol=1e-6)
    (p,) = card({"K562": data}, "t", models=("FFNN", "CNN"))["K562"][
        ("FFNN", "CNN")]["pvalues"]
    assert 0.0 <= p <= 1.0


def _small_served(rows):
    """A small EmbraceNet served on the card, and ``rows`` windows for it."""
    flat = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 64, "CNN_n_layers": 1,
            "CNN_out_channels_l0": 32, "CNN_kernel_size_l0": 11,
            "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
            "selection_probabilities_FFNN": 0.5}
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, 16)
    model = ReloadedModel("EmbraceNetMultimodal", params, bn, flat,
                          in_features_ffnn=16)
    rng = np.random.default_rng(0)
    data = {"ffnn": rng.normal(size=(rows, 16)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(rows, 256), dtype=np.uint8)}
    return model, data


def test_device_trace_names_the_kernel_after_a_predict(cuda, tmp_path):
    import glob

    model, data = _small_served(300)
    before = _launches()
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("predict"):
            model(data)
    assert _launches() == before + 1
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(path) as fh:
        trace = fh.read()
    assert "embrace_fused_fwd_kernel" in trace and '"predict"' in trace


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fused_embrace", "fused_embrace_fulle"])
def test_trial_axis_launch_equals_single_launches(cuda, kernel, dtype):
    """One launch of 3 trials (each its own weights, p0, live width and
    seed): every trial's ``choose`` and ``out`` equal its single launch's
    bit for bit (the plan is one trial's, so its sums run in one order),
    and ``out`` is the plain version's ``where(choose, d0, d1)``."""
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    fn = getattr(K, kernel)
    per = [_inputs(cuda, dtype, live=live) for live in (256, 128, 384)]
    x0, x1, w0, b0, w1, b1, e_mask = (torch.stack(a) for a in zip(*per))
    args = (x0, x1, w0, b0, w1, b1)
    p0 = torch.rand(3, x0.shape[1], device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    seeds = torch.tensor([3, 4, 5], device=cuda)
    name = ("embrace.launches" if kernel == "fused_embrace" else
            "embrace.launches_fulle")
    before = _launches(name)
    out, ch = fn(*args, p0, e_mask, seeds)
    assert _launches(name) == before + 1
    for t in range(3):
        o, c = fn(*(a[t] for a in args), p0[t], e_mask[t], seeds[t])
        assert torch.equal(c, ch[t]) and torch.equal(o, out[t])
    ones = torch.ones_like(p0)
    u = torch.zeros(out.shape, device=cuda)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u)
    d1, _ = K.fused_embrace_reference(*args, 0 * ones, e_mask, u)
    torch.testing.assert_close(out, torch.where(ch.bool(), d0, d1),
                               rtol=tol, atol=tol)


def test_population_step_on_the_card_equals_the_cpu(cuda):
    """``engine.population_step`` of two mixed trials on the card equals
    the CPU's under ``exact_float32`` (float32 products and cuDNN
    convolutions with TF32 off, backward included): losses within 1e-5
    relative, logits and new params within 1e-4 of their largest value
    (sums in another order; conv biases left out: a BatchNorm follows each
    conv, so their gradient is 0 but for rounding, and Adam moves them by
    its lr whatever that rounding is)."""
    from embracenet_tpu_torch.convert import tree_to_torch
    from embracenet_tpu_torch.models import layers
    from embracenet_tpu_torch.ops import optim

    spec, hps, opts, train, _ = _fit_inputs()
    flat2 = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "CNN_n_layers": 2,
             "CNN_out_channels_l0": 16, "CNN_kernel_size_l0": 5,
             "CNN_out_channels_l1": 32, "CNN_kernel_size_l1": 15,
             "EMBRACENET_embracement_size": 768, "n_post_layers": 0,
             "selection_probabilities_FFNN": 0.3, "optimizer": "RMSprop",
             "lr": 1e-3, "weight_decay": 1e-4}
    hps = hps + [space.params_to_hp("EmbraceNetMultimodal", flat2)]
    opts = opts + [space.optimizer_hp(flat2)]
    inits = [spec.init(torch.Generator().manual_seed(s), h)
             for s, h in zip((1, 2), hps)]
    params = engine.stack_trials([i[0] for i in inits])
    bn = engine.stack_trials([i[1] for i in inits])
    statics = dict(engine._resolve_statics(spec, hps, TrainConfig()))
    y = torch.as_tensor(train["y"][:64])
    out = []
    for dev in ("cpu", cuda):
        p, b = tree_to_torch(params, dev), tree_to_torch(bn, dev)
        opt_hp = {k: torch.as_tensor(np.asarray([o[k] for o in opts]),
                                     device=dev) for k in
                  ("optimizer", "lr", "weight_decay")}
        opt_hp["lr"] = opt_hp["lr"].float()
        opt_hp["weight_decay"] = opt_hp["weight_decay"].float()
        inputs = {"ffnn": torch.as_tensor(train["ffnn"][:64], device=dev),
                  "cnn": torch.as_tensor(train["cnn"][:64], device=dev)}
        # no dropout draws: the generators of the two devices differ
        trials = layers.Trials(hps, layers.stack_hps(hps, dev), None,
                               layers.Draws([None, None], [64, 64], dev))
        loss, logits, new_p, _, _ = engine.population_step(
            spec, p, b, optim.init_state(p, lead=(2,)), trials, opt_hp,
            inputs, y.to(dev), torch.ones(2, 64, device=dev), None,
            dict(statics, fused_embrace=False))
        out.append((loss.cpu(), logits.cpu(), tree_to_torch(new_p, "cpu")))
    (l_cpu, z_cpu, p_cpu), (l_card, z_card, p_card) = out
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(z_card, z_cpu, rtol=1e-4,
                               atol=1e-4 * float(z_cpu.abs().max()))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    for (name, a), (_, b) in zip(leaves(p_card), leaves(p_cpu)):
        if not name.rsplit("/", 1)[-1].startswith("conv_b"):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()),
                                       msg=lambda m, n=name: f"{n}: {m}")


def test_checkpoint_second_backend_saves_card_tensors(cuda, tmp_path):
    """``save_checkpoint_orbax`` straight from tensors on the card; the load
    gives their values, dtypes and shapes (0-d included) on the host."""
    from embracenet_tpu_torch.training.checkpoint import (load_checkpoint_orbax,
                                                          save_checkpoint_orbax)

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"params": {"w": torch.randn(64, 32, generator=gen, device=cuda),
                       "lstm": [{"b": torch.randn(8, generator=gen, device=cuda)}],
                       "step": torch.tensor(3, dtype=torch.int32, device=cuda)},
            "bn_state": {}}
    save_checkpoint_orbax(str(tmp_path / "ck"), tree, {"model": "FFNN"})
    got, meta = load_checkpoint_orbax(str(tmp_path / "ck"))
    assert meta == {"model": "FFNN"} and got["bn_state"] == {}
    for g, w in ((got["params"]["w"], tree["params"]["w"]),
                 (got["params"]["lstm"][0]["b"], tree["params"]["lstm"][0]["b"]),
                 (got["params"]["step"], tree["params"]["step"])):
        assert isinstance(g, np.ndarray) and g.shape == tuple(w.shape)
        assert torch.equal(torch.from_numpy(g), w.cpu())


def test_fused_launches_fall_inside_their_microbatch_spans(cuda):
    """The program's spans share the device trace's clock: in a traced
    10,000-window request each fused kernel's runtime launch call lies
    inside one ``reload.microbatch`` span (one a micro-batch), and the
    kernel starts after that span begins."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, data = _small_served(10_000)
    model(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(data)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = [(e.start_ns(), e.end_ns()) for e in host
             if e.name() == "reload.microbatch"]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and "embrace_fused_fwd" in e.name()]
    assert len(spans) == 3 and len(kernels) == 3
    for k in kernels:
        # CUPTI gives the launch call and its kernel one correlation id
        (launch,) = [e for e in host if "Launch" in e.name()
                     and e.correlation_id() == k.correlation_id()]
        inside = [s for s in spans
                  if s[0] <= launch.start_ns() <= launch.end_ns() <= s[1]]
        assert len(inside) == 1, (launch.name(), launch.start_ns(), spans)
        assert k.start_ns() >= inside[0][0]


# the CNN's supernet blocks (C, O, L) at 15 taps: the float32 population's
# convolutions, which run as per-trial GEMMs over im2col windows but for
# the first block's (4 x 15-deep windows: cuDNN)
CONV_BLOCKS = [(4, 64, 256), (64, 96, 124), (96, 256, 58), (256, 512, 25)]


def _conv_trial0(x, w, g, t):
    """Trial 0's forward and both gradients of ``layers.conv1d_trials``
    over the first ``t`` trials (a lone trial inside
    ``population_invariant``, as ``engine.fit`` runs it)."""
    from embracenet_tpu_torch.models import layers

    c, o = w.shape[2], w.shape[1]
    xs = x[:, :t * c].clone().requires_grad_(True)
    ws = w[:t].clone().requires_grad_(True)
    with layers.exact_float32(), layers.population_invariant():
        y = layers.conv1d_trials(xs, ws)
        gx, gw = torch.autograd.grad(y, (xs, ws), g[:, :t * o])
    return y[:, :o], gx[:, :c], gw[0]


def _conv_inputs(dev, c, o, length, t=9, b=100):
    gen = torch.Generator(device=dev).manual_seed(c * 1000 + o)
    x = torch.randn(b, t * c, length, generator=gen, device=dev)
    w = torch.randn(t, o, c, 15, generator=gen, device=dev) * (c * 15) ** -0.5
    g = torch.randn(b, t * o, length, generator=gen, device=dev)
    return x, w, g


@pytest.mark.parametrize("c,o,length", CONV_BLOCKS)
def test_conv_gemm_sums_a_trial_alike_in_any_population(cuda, c, o, length):
    """At each supernet block, trial 0's forward and both gradients are
    the same bits in populations of 1, 2, 8 and 9 trials, and a second run
    gives the same bits again (the last population of 2)."""
    x, w, g = _conv_inputs(cuda, c, o, length)
    two = _conv_trial0(x, w, g, 2)
    for t in (1, 8, 9, 2):
        got = _conv_trial0(x, w, g, t)
        for name, a, b in zip(("y", "dx", "dw"), got, two):
            assert torch.equal(a, b), (t, name)


@pytest.mark.parametrize("c,o,length", CONV_BLOCKS)
def test_conv_gemm_matches_cudnn_grouped_convolution(cuda, c, o, length):
    """At each supernet block, 8 trials' forward and both gradients within
    1e-5 of the largest value of cuDNN's grouped convolution under
    ``exact_float32`` (float32 sums in another order); ``conv.gemm``
    counts the GEMM path at blocks 2-4 and not at block 1."""
    import torch.nn.functional as F

    from embracenet_tpu_torch.models import layers

    t = 8
    x, w, g = _conv_inputs(cuda, c, o, length, t)
    before = profiling.counters().get("conv.gemm", 0)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with layers.exact_float32():
        y = layers.conv1d_trials(xs, ws)
        got = (y,) + torch.autograd.grad(y, (xs, ws), g)
        y = F.conv1d(xs, ws.reshape(t * o, c, 15), padding=7, groups=t)
        want = (y,) + torch.autograd.grad(y, (xs, ws), g)
    gemm = c * 15 >= layers._GEMM_MIN_DEPTH
    assert gemm == (c > 4)
    assert profiling.counters().get("conv.gemm", 0) == before + gemm
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5,
                                   atol=1e-5 * float(b.detach().abs().max()),
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_fit_on_the_card_runs_its_convolutions_as_gemms(cuda):
    """A float32 fit of one trial on the card, two CNN blocks: the second
    (32 x 5-deep windows) takes the GEMM path inside
    ``population_invariant``, one ``conv.gemm`` a forward, and the first
    (4 x 11) stays on cuDNN."""
    spec, hps, opts, train, test = _fit_inputs()
    flat = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "CNN_n_layers": 2,
            "CNN_out_channels_l0": 32, "CNN_kernel_size_l0": 11,
            "CNN_out_channels_l1": 64, "CNN_kernel_size_l1": 5,
            "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
            "selection_probabilities_FFNN": 0.5, "optimizer": "Adam",
            "lr": 1e-3, "weight_decay": 1e-4}
    hps = [space.params_to_hp("EmbraceNetMultimodal", flat)]
    before = profiling.counters().get("conv.gemm", 0)
    engine.fit(spec, hps, [space.optimizer_hp(flat)], train, test,
               TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=100))
    # 4 train batches and 1 eval batch an epoch
    assert profiling.counters()["conv.gemm"] - before == 2 * (4 + 1)


def _cell_population(config):
    """A benchmark configuration's population: (spec, hps), as
    ``tools/torch_init_draws_bench.py`` reads it."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_init_draws_bench

    return torch_init_draws_bench.population(config)


def _same_init(got, want):
    from embracenet_tpu_torch.convert import tree_leaves

    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a.cpu(), b), "the card drew other numbers"


def test_device_draws_equal_the_host_draws_for_the_pop8_population(cuda):
    """The 8 supernet trials of ``embracenet-hepg2`` (11.96 M numbers
    each), seeded as a fit seeds them: the kernel's leaves are the CPU
    generators' bit for bit, and it launches once."""
    spec, hps = _cell_population("embracenet-hepg2")
    seeds, _ = engine.seed_streams(2**31 + 12345, len(hps))
    before = _launches("mt19937.launches")
    got = engine.init_population(spec, hps, seeds, cuda)
    torch.cuda.synchronize()
    assert _launches("mt19937.launches") == before + 1
    _same_init(got, engine.host_init(spec, hps, seeds))


@pytest.mark.parametrize("trial", range(8))
def test_device_draws_equal_the_host_draws_for_each_cnn_lstm_trial(cuda,
                                                                    trial):
    """Each of ``cnn_lstm-hepg2``'s 8 architectures as a lone fit draws it
    (trial 1: one stream of ~127.1 M words), seeded as group ``trial`` of
    a search."""
    spec, hps = _cell_population("cnn_lstm-hepg2")
    seeds, _ = engine.seed_streams(1900000505 + 7919 * trial, 1)
    got = engine.init_population(spec, hps[trial:trial + 1], seeds, cuda)
    _same_init(got, engine.host_init(spec, hps[trial:trial + 1], seeds))


@pytest.mark.parametrize("n_trials,n_pad", [(1, 0), (3, 1), (5, 3)])
def test_device_draws_of_one_trial_and_of_a_mesh_padded_population(
        cuda, n_trials, n_pad):
    """T = 1, and populations padded to a trial mesh's multiple with
    copies of their last trial (seed and all), as ``engine.fit`` pads
    them, at mixed widths."""
    spec, hps = _cell_population("embracenet-hepg2")
    seeds = list(range(2**32 - 2, 2**32 - 2 + n_trials))
    (hps, seeds), _ = engine._pad_population(n_pad, (hps[:n_trials], seeds),
                                             ())
    _same_init(engine.init_population(spec, hps, seeds, cuda),
               engine.host_init(spec, hps, seeds))


@pytest.mark.parametrize("width_buckets", [False, True])
def test_a_fit_on_the_card_starts_from_the_cpu_init(cuda, monkeypatch,
                                                    width_buckets):
    """``engine.fit`` on the card draws its population there: the params
    its first step takes are the CPU init's bit for bit (cut to the width
    buckets where the fit cuts them), and ``engine.init_device_draws`` and
    ``engine.to_device_bytes`` read what they read for the same fit on the
    CPU, which draws its init there through the same plan: every drawn
    number, and copies of the init's constants alone."""
    from embracenet_tpu_torch.convert import tree_leaves, tree_map
    from embracenet_tpu_torch.models.layers import InitPlan
    from embracenet_tpu_torch.training import slicing

    spec, hps, opts, train, test = _fit_inputs()
    hps, opts = hps * 2, opts * 2
    first = []
    step = engine.population_step

    def spy(spec_, params, *args, **kw):
        if not first:
            first.append(tree_map(lambda a: a.detach().cpu().clone(), params))
        return step(spec_, params, *args, **kw)

    monkeypatch.setattr(engine, "population_step", spy)
    cfg = TrainConfig(num_epochs=1, batch_size=100, seed=2**31 + 7,
                      width_buckets=width_buckets)
    counts = []
    for dev in ("cpu", cuda):
        first.clear()
        profiling.reset_counters()
        engine.fit(spec, hps, opts, train, test, cfg, device=dev)
        counts.append(profiling.counters())
    seeds, _ = engine.seed_streams(cfg.seed, 2)
    params, bn_state = engine.host_init(spec, hps, seeds)
    statics = engine._resolve_statics(spec, hps, cfg)
    assert slicing.has_width_statics(statics) == width_buckets
    if width_buckets:
        params, bn_state = slicing.shrink(spec.name, params, bn_state,
                                          statics)
    for a, b in zip(tree_leaves(first[0]), tree_leaves(params)):
        assert torch.equal(a, b)
    plan = InitPlan()
    spec.init(plan, hps[0])
    drawn = 2 * sum(int(np.prod(s)) for s in plan.shapes)
    cpu, card = counts
    assert card["engine.init_device_draws"] == cpu[
        "engine.init_device_draws"] == drawn
    assert card["mt19937.launches"] == 1 and "mt19937.launches" not in cpu
    assert card["engine.to_device_bytes"] == cpu["engine.to_device_bytes"]


def _update_inputs(dev, shapes, lead, s_dtype=None, master=False, seed=0,
                   none_leaf=None, misaligned=False):
    """A tree of leaves ``[*lead, *shape]`` drawn on ``dev``, its state
    (``optim.init_state``) and a gradient maker: leaf ``none_leaf``'s
    gradient None; with ``misaligned`` every gradient sits one element
    past a 16-byte boundary."""
    from embracenet_tpu_torch.convert import tree_map
    from embracenet_tpu_torch.ops import optim

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {f"l{i}": torch.randn(*lead, *s, generator=gen, device=dev)
              for i, s in enumerate(shapes)}
    state = optim.init_state(params, s_dtype, master, lead=lead)
    if master:
        params = tree_map(lambda a: a.to(torch.bfloat16), params)

    def grads():
        out = {}
        for i, (k, p) in enumerate(params.items()):
            g = torch.randn(p.numel() + 1, generator=gen, device=dev) * 1e-2
            g = g[1:] if misaligned else g[:-1]
            out[k] = None if i == none_leaf else g.to(p.dtype).view(p.shape)
        return out

    return params, state, grads


def _hp(dev, n):
    """Mixed optimizers (Adam, Nadam, RMSprop in turn) and rates for ``n``
    trials ([n] tensors; 0-d for ``n`` None)."""
    ids = torch.arange(n or 1, device=dev) % 3
    lr = torch.linspace(1e-3, 3e-2, n or 1, device=dev)
    wd = torch.linspace(0.0, 1e-3, n or 1, device=dev)
    return (ids, lr, wd) if n else (ids[0], lr[0], wd[0])


def _updates_alike(params, state, grads, hp, upds, steps=3):
    """``steps`` chained calls of ``apply_update`` (the kernel) and of its
    plain version from the same state: params, m, v, master, step and
    m_schedule equal bit for bit at every step, the kernel's inputs left as
    they were, and one launch a call."""
    from embracenet_tpu_torch.convert import tree_leaves
    from embracenet_tpu_torch.ops import optim

    for step in range(steps):
        g = grads()
        upd = upds[step % len(upds)]
        ins = [t for t in tree_leaves((params, g, state)) if t is not None]
        copies = [t.clone() for t in ins]
        before = _launches("optim.launches")
        new_p, new_s = optim.apply_update(params, g, state, *hp, upd)
        assert _launches("optim.launches") == before + 1
        ref_p, ref_s = optim.apply_update_reference(params, g, state, *hp,
                                                    upd)
        torch.cuda.synchronize()
        assert sorted(new_s) == sorted(ref_s)
        for a, b in zip(tree_leaves((new_p, new_s)),
                        tree_leaves((ref_p, ref_s))):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.is_contiguous() and a.device.type == "cuda"
            assert torch.equal(a, b), f"step {step}: the kernel differs"
        for a, b in zip(ins, copies):
            assert torch.equal(a, b), "the kernel wrote into its inputs"
        params, state = new_p, new_s


@pytest.mark.parametrize("s_dtype,master", [(None, False),
                                            (torch.bfloat16, False),
                                            (None, True)],
                         ids=["float32", "bf16_state", "bf16_master"])
def test_fused_update_equals_the_plain_version_bit_for_bit(cuda, s_dtype,
                                                           master):
    """Five trials of mixed optimizers, odd and aligned leaves, one None
    gradient, trials frozen on the second step: the kernel's update is the
    plain version's bit for bit over three chained steps, in float32, with
    bf16 m and v, and with bf16 params over a float32 master."""
    shapes = [(566, 256), (256,), (7, 3), (64, 4, 15), (1,), (8200,)]
    params, state, grads = _update_inputs(cuda, shapes, (5,), s_dtype,
                                          master, none_leaf=2)
    upds = [None, torch.tensor([True, False, True, True, False], device=cuda)]
    _updates_alike(params, state, grads, _hp(cuda, 5), upds)


def test_fused_update_at_the_pop8_population(cuda):
    """``embracenet-hepg2``'s 8 trials at their 34 leaf shapes, with their
    own optimizers and rates, as a fit draws them: bit for bit."""
    from embracenet_tpu_torch.convert import tree_leaves, tree_unflatten
    from embracenet_tpu_torch.ops import optim

    import sys
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import torch_optim_bench

    params, opt_hp = torch_optim_bench.pop8(cuda, 2**31 + 23)
    assert len(tree_leaves(params)) == 34
    gen = torch.Generator(device=cuda).manual_seed(1)

    def grads():
        return tree_unflatten(params, [
            torch.randn(p.shape, generator=gen, device=cuda) * 1e-2
            for p in tree_leaves(params)])

    hp = (opt_hp["optimizer"], opt_hp["lr"].float(),
          opt_hp["weight_decay"].float())
    _updates_alike(params, optim.init_state(params, lead=(8,)), grads, hp,
                   [None], steps=2)


@pytest.mark.parametrize("lead", [(1,), ()], ids=["T1", "no_trial_axis"])
def test_fused_update_of_one_trial_with_misaligned_leaves(cuda, lead):
    """One trial (a stacked population of one, and 0-d state) whose leaves
    have odd sizes and whose gradients start off a 16-byte boundary: the
    scalar path, bit for bit."""
    params, state, grads = _update_inputs(
        cuda, [(13,), (3, 5, 7), (9001,), (2,)], lead, misaligned=True)
    _updates_alike(params, state, grads, _hp(cuda, lead[0] if lead else None),
                   [None])


def test_fused_update_coefficients_over_many_steps(cuda):
    """4,096 one-number trials at steps 0 to 4,095, with momentum schedules
    spread over (0.02, 1), each optimizer and a frozen trial in every few:
    the kernel's per-trial coefficients, new step and momentum schedule are
    the plain version's bit for bit at every step."""
    from embracenet_tpu_torch.ops import optim

    n = 4096
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = {"w": torch.randn(n, 1, generator=gen, device=cuda)}
    state = optim.init_state(params, lead=(n,))
    state["m"]["w"] = torch.randn(n, 1, generator=gen, device=cuda) * 1e-3
    state["v"]["w"] = torch.rand(n, 1, generator=gen, device=cuda) * 1e-5
    state["step"] = torch.arange(n, device=cuda, dtype=torch.float32)
    state["m_schedule"] = 0.02 + 0.98 * torch.rand(n, generator=gen,
                                                   device=cuda)
    grads = {"w": torch.randn(n, 1, generator=gen, device=cuda) * 1e-2}
    hp = (torch.arange(n, device=cuda, dtype=torch.int32) % 3,
          torch.full((n,), 3e-3, device=cuda),
          torch.full((n,), 1e-4, device=cuda))
    upd = torch.arange(n, device=cuda) % 7 != 3
    new = optim.apply_update(params, grads, state, *hp, upd)
    ref = optim.apply_update_reference(params, grads, state, *hp, upd)
    for name, a, b in (("params", new[0]["w"], ref[0]["w"]),
                       ("m", new[1]["m"]["w"], ref[1]["m"]["w"]),
                       ("v", new[1]["v"]["w"], ref[1]["v"]["w"]),
                       ("step", new[1]["step"], ref[1]["step"]),
                       ("m_schedule", new[1]["m_schedule"],
                        ref[1]["m_schedule"])):
        diff = (a != b).nonzero().flatten()[:5].tolist()
        assert not diff, f"{name} differs at trials {diff}"


def test_fused_update_refuses_what_it_does_not_take(cuda):
    """A non-contiguous leaf, a float16 one, state of another shape and
    more leaves than the kernel's arguments hold raise before any
    launch."""
    from embracenet_tpu_torch.ops import optim

    params, state, grads = _update_inputs(cuda, [(4, 6)], (2,))
    before = _launches("optim.launches")
    bad = {"l0": params["l0"].transpose(1, 2)}
    with pytest.raises(ValueError, match="contiguous"):
        optim.apply_update(bad, grads(), optim.init_state(bad, lead=(2,)),
                           *_hp(cuda, 2))
    half = {"l0": params["l0"].half()}
    with pytest.raises(ValueError, match="float16"):
        optim.apply_update(half, {"l0": None}, optim.init_state(half,
                                                                lead=(2,)),
                           *_hp(cuda, 2))
    with pytest.raises(ValueError, match="shape"):
        optim.apply_update(params, {"l0": torch.zeros(2, 6, 4, device=cuda)},
                           state, *_hp(cuda, 2))
    many, many_state, many_grads = _update_inputs(
        cuda, [(3,)] * (optim.MAX_LEAVES + 1), (2,))
    with pytest.raises(ValueError, match="up to 64 leaves"):
        optim.apply_update(many, many_grads(), many_state, *_hp(cuda, 2))
    assert _launches("optim.launches") == before


def test_a_fit_on_the_card_updates_through_the_kernel(cuda):
    """``engine.fit`` launches the update kernel once a train step."""
    profiling.reset_counters()
    engine.fit(*_fit_inputs(), TrainConfig(num_epochs=2, batch_size=100))
    got = profiling.counters()
    assert got["optim.launches"] == got["engine.train_steps"] > 0
