"""Chip smoke test of the PyTorch/CUDA port (``embracenet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them.  It

1. builds the fused embrace kernel (``embracenet_tpu_torch/csrc/embrace.cu``)
   with nvcc for sm_90a and prints the build time and ptxas' report;
2. kernel phase: holds the kernel against its plain PyTorch version at the
   serving path's shape (B=4096, D0=256, D1=7936, E=1024), at a ragged
   shape (B=100, D0=200, D1=5568, E=768 with e_mask live on 512) and at the
   train phase's shapes (B=100 and, for evaluation, B=200, with D0=256,
   D1=7936, E=1024), in float32 and bf16 operands: p0 = 1 and p0 = 0 give the plain version's
   d0 / d1, a per-row p0 spread over [0, 1] gives exactly
   ``where(choose, d0, d1)`` (tolerance: float32 rtol = atol = 1e-4, the
   K-sum taken in another order; bf16 1e-2 against the plain version on the
   same bf16 operands), each row's choose frequency lies within 0.01 of its
   p0, masked columns are exactly 0, and a seed repeats bit for bit while
   the next seed differs.  It times kernel and plain version with CUDA
   events (no single PyTorch call computes this function, so there is no
   library time: ``library_ms`` is null);
3. serve phase: builds the widest EmbraceNetMultimodal of the search space
   (FFNN 256/128/64/32, CNN 64/96/256/512 with 15-tap kernels, embracement
   1024, post layers 512/256, 566 tabular features as HEPG2) from a seeded
   generator, saves it as a checkpoint, and answers 3 ``predict`` requests
   of 10,000 windows on the card through ``load_model``; the kernel must
   have been launched 3 * ceil(10000 / 4096) = 9 times.  Then it checks
   ``evaluate``, the fused path against the unfused one at
   selection_probabilities_FFNN in {0, 1}, and the card against the port on
   the CPU on 64 windows;
4. kernel-fulle phase: holds the full-E kernel (``fused_embrace_fulle``)
   to the same checks at the same shapes, and requires its ``choose`` to
   equal ``fused_embrace``'s bit for bit for the same seed and its ``out``
   to match within 1e-4 (float32) / 1e-2 (bf16);
5. gradient phase: at the serving shape and at the training batch (B=100)
   in float32, the fused Function's dx0, dx1, dw0, db0, dw1, db1 equal
   autograd through the unfused path at p0 = 1 and p0 = 0 within
   1e-4 x max|grad|; times forward + backward of both;
6. train phase: ``engine.fit`` on the card for the widest
   EmbraceNetMultimodal (566 features, Adam lr 1e-3, batch 100, float32,
   fused kernel on) over learnable synthetic data from seed 0 (3,000 train
   and 1,000 test windows, as ``bench.py``'s ``make_data``), 3 epochs in one
   chunk: finite losses and AUPRCs, 3 epochs run, parameters that moved,
   and exactly one kernel launch per forward pass the plans call for.  Then
   a population of 8 trials drawn as ``bench.py`` draws them (seeds 0-7),
   split by ``plan_buckets``, bf16, 1 epoch, and its train windows/s;
7. bench phase: ``tools/torch_embrace_bench.py``'s ``block_bench`` at
   B=4096 (few iterations) and ``engine_bench(True)``, the entry point that
   reaches the full-E kernel;
8. prints the card's name and power limit, the ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

import embracenet_tpu_torch as et
from embracenet_tpu_torch.benchkit import (IN_FEATURES, bound, cuda_ms,
                                           make_data, nvidia_smi,
                                           widest_flat_params)
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_to_numpy
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models import embracenet
from embracenet_tpu_torch.models.reload import load_model
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
from embracenet_tpu_torch.training.bucketing import plan_buckets
from embracenet_tpu_torch.training.checkpoint import save_checkpoint
from embracenet_tpu_torch.training.modelspec import get_spec

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_embrace_bench as bench  # noqa: E402

MAIN = dict(B=4096, D0=256, D1=7936, E=1024, live=1024)
RAGGED = dict(B=100, D0=200, D1=5568, E=768, live=512)
# the train phase's shapes: a training batch of 100, an eval batch of 200
TRAIN = dict(B=100, D0=256, D1=7936, E=1024, live=1024)
EVAL = dict(B=200, D0=256, D1=7936, E=1024, live=1024)
SHAPES = (MAIN, RAGGED, TRAIN, EVAL)
N_WINDOWS = 10_000
N_REQUESTS = 3


def require(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def case_inputs(shape, dtype, dev, gen):
    """x0, x1, w0, b0, w1, b1, e_mask at ``shape``; the weights are views
    w[:D, :E] of wider tensors, as the model's bucket slices of dock*_w
    are."""
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x0 = torch.relu(randn(B, D0)).to(dtype)
    x1 = torch.relu(randn(B, D1)).to(dtype)
    w0 = randn(D0 + 56, E + 256, scale=D0 ** -0.5).to(dtype)[:D0, :E]
    w1 = randn(D1, E + 256, scale=D1 ** -0.5).to(dtype)[:, :E]
    b0, b1 = randn(E, scale=0.1), randn(E, scale=0.1)
    e_mask = (torch.arange(E, device=dev) < live).float()
    return (x0, x1, w0, b0, w1, b1), e_mask


def kernel_case(shape, dtype, dev, gen):
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    args, e_mask = case_inputs(shape, dtype, dev, gen)
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)

    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, torch.zeros(B, E, device=dev))
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, torch.zeros(B, E, device=dev))
    out, ch = K.fused_embrace(*args, ones, e_mask, 1)
    torch.testing.assert_close(out, d0, rtol=tol, atol=tol)
    require(bool((ch == 1).all()), "p0 = 1 must always choose modality 0")
    out, ch = K.fused_embrace(*args, zeros, e_mask, 1)
    torch.testing.assert_close(out, d1, rtol=tol, atol=tol)
    require(bool((ch == 0).all()), "p0 = 0 must never choose modality 0")

    p0 = torch.linspace(0, 1, B, device=dev)
    out, ch = K.fused_embrace(*args, p0, e_mask, 7)
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    max_err = float((out - want).abs().max())
    require(bool((out[:, live:] == 0).all()), "masked columns must be 0")
    again, ch_again = K.fused_embrace(*args, p0, e_mask, 7)
    require(torch.equal(out, again) and torch.equal(ch, ch_again),
            "the same seed must repeat bit for bit")
    _, ch_next = K.fused_embrace(*args, p0, e_mask, 8)
    require(not torch.equal(ch, ch_next), "seed + 1 must draw anew")

    seeds = 128 if B > 1000 else 256
    hits = torch.zeros(B, device=dev)
    for s in range(seeds):
        hits += K.fused_embrace(*args, p0, e_mask, 1000 + s)[1].sum(1)
    freq_err = float((hits / (seeds * E) - p0).abs().max())
    require(freq_err < 0.01, f"choose frequency off p0 by {freq_err}")

    u = torch.rand(B, E, generator=gen, device=dev)
    ms = cuda_ms(lambda: K.fused_embrace(*args, p0, e_mask, 3))
    plain_ms = cuda_ms(lambda: K.fused_embrace_reference(*args, p0, e_mask, u))
    bound_ms, bound_by, flops, nbytes = bound(B, D0, D1, E, dtype)
    return {"shape": [B, D0, D1, E], "dtype": str(dtype).split(".")[-1],
            "max_abs_err": max_err, "freq_err": freq_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "tflops": flops / ms / 1e9,
            "library_ms": None, "library": "none: no single PyTorch call "
            "docks two modalities and selects between them"}


def fulle_case(shape, dtype, dev, gen):
    """The full-E kernel held to the tiled kernel's checks, plus: the same
    choose bit for bit as ``fused_embrace`` and out within ``tol``."""
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    args, e_mask = case_inputs(shape, dtype, dev, gen)
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    u0 = torch.zeros(B, E, device=dev)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u0)
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, u0)
    out, ch = K.fused_embrace_fulle(*args, ones, e_mask, 1)
    torch.testing.assert_close(out, d0, rtol=tol, atol=tol)
    require(bool((ch == 1).all()), "fulle: p0 = 1 must always choose modality 0")
    out, ch = K.fused_embrace_fulle(*args, zeros, e_mask, 1)
    torch.testing.assert_close(out, d1, rtol=tol, atol=tol)
    require(bool((ch == 0).all()), "fulle: p0 = 0 must never choose modality 0")

    p0 = torch.linspace(0, 1, B, device=dev)
    out, ch = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    max_err = float((out - want).abs().max())
    require(bool((out[:, live:] == 0).all()), "fulle: masked columns must be 0")
    tiled, ch_tiled = K.fused_embrace(*args, p0, e_mask, 7)
    require(torch.equal(ch, ch_tiled),
            "fulle must choose as fused_embrace for the same seed")
    torch.testing.assert_close(out, tiled, rtol=tol, atol=tol)
    vs_tiled = float((out - tiled).abs().max())
    again, ch_again = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    require(torch.equal(out, again) and torch.equal(ch, ch_again),
            "fulle: the same seed must repeat bit for bit")
    seeds = 128 if B > 1000 else 256
    hits = torch.zeros(B, device=dev)
    for s in range(seeds):
        hits += K.fused_embrace_fulle(*args, p0, e_mask, 1000 + s)[1].sum(1)
    freq_err = float((hits / (seeds * E) - p0).abs().max())
    require(freq_err < 0.01, f"fulle: choose frequency off p0 by {freq_err}")

    u = torch.rand(B, E, generator=gen, device=dev)
    ms = cuda_ms(lambda: K.fused_embrace_fulle(*args, p0, e_mask, 3))
    plain_ms = cuda_ms(lambda: K.fused_embrace_reference(*args, p0, e_mask, u))
    bound_ms, bound_by, flops, nbytes = bound(B, D0, D1, E, dtype)
    return {"shape": [B, D0, D1, E], "dtype": str(dtype).split(".")[-1],
            "blocks": math.ceil(B / 8), "max_abs_err": max_err,
            "max_abs_vs_tiled": vs_tiled, "freq_err": freq_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / ms / 1e9, "library_ms": None,
            "library": "none: no single PyTorch call docks two modalities "
            "and selects between them"}


def grad_phase(shape, dev, gen):
    """The fused Function's gradients against autograd through the unfused
    path (the plain version, differentiated by torch) at p0 in {1, 0}, at
    ``shape`` in float32."""
    B, E = shape["B"], shape["E"]
    (x0, x1, w0, b0, w1, b1), e_mask = case_inputs(shape, torch.float32, dev, gen)
    g_out = torch.randn(B, E, generator=gen, device=dev)
    u = torch.zeros(B, E, device=dev)
    out = {"shape": [B, shape["D0"], shape["D1"], E]}

    def leaves():
        return [t.detach().clone().requires_grad_(True)
                for t in (x0, x1, w0, b0, w1, b1)]

    def fused(p0):
        ins = leaves()
        o, _ = K.fused_embrace(*ins, p0, e_mask, 5)
        return torch.autograd.grad((o * g_out).sum(), ins)

    def unfused(p0):
        ins = leaves()
        o, _ = K.fused_embrace_reference(*ins, p0, e_mask, u)
        return torch.autograd.grad((o * g_out).sum(), ins)

    names = ("dx0", "dx1", "dw0", "db0", "dw1", "db1")
    for label, p0 in (("p0=1", torch.ones(B, device=dev)),
                      ("p0=0", torch.zeros(B, device=dev))):
        errs = {}
        for name, gf, gu in zip(names, fused(p0), unfused(p0)):
            scale = max(float(gu.abs().max()), 1e-30)
            err = float((gf - gu).abs().max())
            require(err <= 1e-4 * scale,
                    f"{name} at {label}: fused vs unfused {err} > 1e-4 x {scale}")
            errs[name] = err / scale
        out[label] = errs
    p0 = torch.full((B,), 0.5, device=dev)
    out["fwd_bwd_fused_ms"] = cuda_ms(lambda: fused(p0), iters=10)
    out["fwd_bwd_unfused_ms"] = cuda_ms(lambda: unfused(p0), iters=10)
    return out


def train_phase():
    data = make_data(4000, IN_FEATURES, np.random.default_rng(0))
    train = {k: v[:3000] for k, v in data.items()}
    test = {k: v[3000:] for k, v in data.items()}
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    flat = widest_flat_params(0.5)
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    opt = space.optimizer_hp(flat)
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    init = {k: v.numpy().copy() for k, v in params.items() if not isinstance(v, dict)}
    epochs, batch = 3, 100
    cfg = TrainConfig(num_epochs=epochs, epoch_chunk=epochs, batch_size=batch)

    # -- the main path: engine.fit on the card, fused kernel on (default) --
    K.LAUNCHES = 0
    t0 = time.perf_counter()
    res = engine.fit(spec, [hp], [opt], train, test, cfg,
                     init_params=engine.stack_trials([params]),
                     init_bn_state=engine.stack_trials([bn]))
    wall = time.perf_counter() - t0
    launches = K.LAUNCHES
    n_fwd = epochs * (balanced_plan(train["y"], batch, seed=123).idx.shape[0]
                      + eval_plan(len(test["y"]), 2 * batch, seed=123).idx.shape[0])
    require(launches == n_fwd, f"train: {launches} kernel launches, expected "
            f"{n_fwd} (one per forward pass)")
    require(res.epochs_run == [epochs], f"epochs run {res.epochs_run}")
    hist = res.loss_train[0] + res.auprc_train[0] + res.auprc_test[0]
    require(all(math.isfinite(v) for v in hist), f"train: not finite {hist}")
    trained = tree_to_numpy(res.params)
    moved = {k: float(np.abs(trained[k][0] - v).max()) for k, v in init.items()}
    for k in ("dock0_w", "dock1_w", "dock0_b", "dock1_b", "head_w"):
        require(moved[k] > 0, f"train: {k} did not move")

    # -- a population of 8 trials as bench.py draws them, bf16, 1 epoch --
    flats = [space.sample_params("EmbraceNetMultimodal", np.random.default_rng(i))
             for i in range(8)]
    hps = [space.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    opts = [space.optimizer_hp(f) for f in flats]
    groups = plan_buckets(spec, "EmbraceNetMultimodal", hps, in_features=IN_FEATURES)
    pcfg = TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=batch,
                       compute_dtype="bfloat16", patience=10_000,
                       width_buckets=True)
    pop_launches0 = K.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idxs in groups:
        engine.fit(spec, [hps[i] for i in idxs], [opts[i] for i in idxs],
                   train, test, pcfg)
    pop_wall = time.perf_counter() - t0
    pop_launches = K.LAUNCHES - pop_launches0
    require(pop_launches > 0, "population: the kernel was never launched")
    return {"launches": launches + pop_launches, "single": {
        "launches": launches, "expected_launches": n_fwd, "wall_s": wall,
        "train_windows_per_s": epochs * len(train["y"]) / wall,
        "loss_train": res.loss_train[0], "auprc_train": res.auprc_train[0],
        "auprc_test": res.auprc_test[0], "max_param_move": moved},
        "population": {"trials": 8, "groups": groups, "launches": pop_launches,
                       "wall_s": pop_wall,
                       "train_windows_per_s": 8 * len(train["y"]) / pop_wall}}


def bench_phase():
    K.LAUNCHES_FULLE = 0
    row = bench.block_bench(4096, iters=5)
    launches = K.LAUNCHES_FULLE
    require(launches > 0, "bench: the full-E kernel was never launched")
    eng = bench.engine_bench(True)
    require(eng["kernel_launches"] > 0, "bench: engine_bench(True) launched "
            "no fused kernel")
    return {"launches_fulle": launches, "block": row, "engine_fused": eng}


def serve_phase(workdir):
    rng = np.random.default_rng(0)
    hp = space.params_to_hp("EmbraceNetMultimodal", widest_flat_params(0.5))
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    paths = {}
    for p in (0.5, 0.0, 1.0):
        paths[p] = os.path.join(workdir, f"embracenet_p{p}")
        save_checkpoint(paths[p], {"params": params, "bn_state": bn},
                        {"model": "EmbraceNetMultimodal",
                         "model_params": widest_flat_params(p)})
    requests = [{"ffnn": rng.normal(size=(N_WINDOWS, IN_FEATURES)).astype(np.float32),
                 "cnn": rng.integers(0, 4, size=(N_WINDOWS, 256), dtype=np.uint8),
                 "y": (rng.random(N_WINDOWS) < 0.3).astype(np.int64)}
                for _ in range(N_REQUESTS)]

    # -- the main path: predict requests through load_model, on the card --
    K.LAUNCHES = 0
    walls = []
    for data in requests:
        t0 = time.perf_counter()
        probs = et.predict(paths[0.5], data)
        walls.append(time.perf_counter() - t0)
        require(probs.shape == (N_WINDOWS, 2), f"probs shape {probs.shape}")
        require(bool(np.isfinite(probs).all()), "probabilities must be finite")
        require(bool(np.abs(probs.sum(1) - 1).max() <= 1e-5),
                "probability rows must sum to 1")
    launches = K.LAUNCHES
    want = N_REQUESTS * math.ceil(N_WINDOWS / 4096)
    require(launches == want, f"{launches} kernel launches, expected {want}")

    # -- checks and measurements after the counted run --
    model = load_model(paths[0.5])
    model(requests[0])  # returns numpy: the device has finished
    t0 = time.perf_counter()
    model(requests[1])
    steady = time.perf_counter() - t0
    metrics = et.evaluate(paths[0.5], requests[2])
    require(set(metrics) >= {"AUPRC", "AUROC", "F1", "accuracy"},
            f"evaluate keys {sorted(metrics)}")
    require(all(math.isfinite(v) for v in metrics.values()), "metrics finite")

    small = {k: v[:4096] for k, v in requests[0].items()}
    cpu_rows = 64
    extremes = {}
    for p in (0.0, 1.0):
        fused = load_model(paths[p])(small, logits=True)
        unfused = load_model(paths[p], fused_embrace=False)(small, logits=True)
        np.testing.assert_allclose(fused, unfused, rtol=1e-4, atol=1e-4)
        cpu_model = load_model(paths[p], device="cpu")
        cpu_model.BATCH = cpu_rows
        cpu = cpu_model({k: v[:cpu_rows] for k, v in small.items()}, logits=True)
        np.testing.assert_allclose(fused[:cpu_rows], cpu, rtol=1e-4, atol=1e-4)
        extremes[p] = {"fused_vs_unfused": float(np.abs(fused - unfused).max()),
                       "card_vs_cpu": float(np.abs(fused[:cpu_rows] - cpu).max())}
    return {"launches": launches, "request_s": walls,
            "windows_per_s_request": [N_WINDOWS / w for w in walls],
            "windows_per_s_model_call": N_WINDOWS / steady,
            "evaluate": metrics, "extremes": extremes}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke test "
              "needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    t0 = time.perf_counter()
    K.build()
    K._load()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "nvcc_s": K.BUILD_SECONDS}), flush=True)
    for line in K.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, fulle_cases = [], []
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            case = kernel_case(shape, dtype, dev, gen)
            cases.append(case)
            print(json.dumps({"kernel_case": case, "card": card}), flush=True)
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            case = fulle_case(shape, dtype, dev, gen)
            fulle_cases.append(case)
            print(json.dumps({"kernel_fulle_case": case, "card": card}), flush=True)
    for shape in (MAIN, TRAIN):
        grads = grad_phase(shape, dev, gen)
        print(json.dumps({"gradient": grads, "card": card}), flush=True)

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "embracenet_tpu_torch",
                                                      "_build")) as workdir:
        serve = serve_phase(workdir)
    print(json.dumps({"serve": serve, "card": card}), flush=True)
    train = train_phase()
    print(json.dumps({"train": train, "card": card}), flush=True)
    bench_out = bench_phase()
    print(json.dumps({"bench": bench_out, "card": card}), flush=True)

    def row(name, source_line, launches, cs):
        main_f32 = cs[0]
        return {"name": name, "route": "cuda",
                "source": "embracenet_tpu_torch/csrc/embrace.cu",
                "replaces": f"embracenet_tpu/ops/pallas/embrace.py:{source_line}",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cs
                                   if c["dtype"] == "float32"),
                "ms": main_f32["ms"], "plain_ms": main_f32["plain_ms"],
                "bound_ms": main_f32["bound_ms"], "bound_by": main_f32["bound_by"],
                "library_ms": main_f32["library_ms"]}

    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("embrace_fused_fwd", 39, serve["launches"] + train["launches"], cases),
        row("embrace_fused_fwd_fulle", 78, bench_out["launches_fulle"],
            fulle_cases)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
