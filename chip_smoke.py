"""Chip smoke test of the PyTorch/CUDA port (``embracenet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them.  It

1. builds the fused embrace kernel (``embracenet_tpu_torch/csrc/embrace.cu``)
   with nvcc for sm_90a and prints the build time and ptxas' report;
2. kernel phase: holds the kernel against its plain PyTorch version at the
   serving path's shape (B=4096, D0=256, D1=7936, E=1024) and at a ragged
   shape (B=100, D0=200, D1=5568, E=768 with e_mask live on 512), in
   float32 and bf16 operands: p0 = 1 and p0 = 0 give the plain version's
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
4. prints the card's name and power limit, the ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import embracenet_tpu_torch as et
from embracenet_tpu_torch.config import (CNN_CHANNEL_MENUS, CNN_KERNEL_MENU,
                                         EMBRACE_POST_WIDTH_MENUS,
                                         EMBRACE_SIZE_MENU, FFNN_WIDTH_MENUS)
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models import embracenet
from embracenet_tpu_torch.models.reload import load_model
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.training.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks (dense): CUDA-core float32, bf16 tensor cores, HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
MAIN = dict(B=4096, D0=256, D1=7936, E=1024, live=1024)
RAGGED = dict(B=100, D0=200, D1=5568, E=768, live=512)
IN_FEATURES = 566        # HEPG2, the widest cell line
N_WINDOWS = 10_000
N_REQUESTS = 3


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(B, D0, D1, E, dtype):
    """Least time the card could take: operations over the peak rate of
    their type, or each input read once and each output written once over
    the memory rate, whichever is larger."""
    item = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * B * (D0 + D1) * E
    nbytes = (item * (B * D0 + B * D1 + D0 * E + D1 * E)   # x0 x1 w0 w1
              + 4 * (3 * E + B)                            # b0 b1 e_mask p0
              + 4 * B * E + B * E)                         # out, choose
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def require(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def kernel_case(shape, dtype, dev, gen):
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x0 = torch.relu(randn(B, D0)).to(dtype)
    x1 = torch.relu(randn(B, D1)).to(dtype)
    # the weights are views w[:D, :E] of wider tensors, as the model's
    # bucket slices of dock*_w are
    w0 = randn(D0 + 56, E + 256, scale=D0 ** -0.5).to(dtype)[:D0, :E]
    w1 = randn(D1, E + 256, scale=D1 ** -0.5).to(dtype)[:, :E]
    b0, b1 = randn(E, scale=0.1), randn(E, scale=0.1)
    e_mask = (torch.arange(E, device=dev) < live).float()
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    args = (x0, x1, w0, b0, w1, b1)

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


def widest_flat_params(p_ffnn: float) -> dict:
    flat = {"FFNN_n_layers": len(FFNN_WIDTH_MENUS),
            "CNN_n_layers": len(CNN_CHANNEL_MENUS),
            "EMBRACENET_embracement_size": max(EMBRACE_SIZE_MENU),
            "n_post_layers": len(EMBRACE_POST_WIDTH_MENUS),
            "selection_probabilities_FFNN": p_ffnn,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    for i, menu in enumerate(FFNN_WIDTH_MENUS):
        flat[f"FFNN_n_units_l{i}"] = max(menu)
    for i, menu in enumerate(CNN_CHANNEL_MENUS):
        flat[f"CNN_out_channels_l{i}"] = max(menu)
        flat[f"CNN_kernel_size_l{i}"] = max(CNN_KERNEL_MENU)
    for i, menu in enumerate(EMBRACE_POST_WIDTH_MENUS):
        flat[f"EMBRACENET_n_units_l{i}"] = max(menu)
    return flat


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
    cases = []
    for shape in (MAIN, RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            case = kernel_case(shape, dtype, dev, gen)
            cases.append(case)
            print(json.dumps({"kernel_case": case, "card": card}), flush=True)

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "embracenet_tpu_torch",
                                                      "_build")) as workdir:
        serve = serve_phase(workdir)
    print(json.dumps({"serve": serve, "card": card}), flush=True)

    main_f32 = cases[0]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "embrace_fused_fwd", "route": "cuda",
        "source": "embracenet_tpu_torch/csrc/embrace.cu",
        "replaces": "embracenet_tpu/ops/pallas/embrace.py:39",
        "launches": serve["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["dtype"] == "float32"),
        "ms": main_f32["ms"], "plain_ms": main_f32["plain_ms"],
        "bound_ms": main_f32["bound_ms"], "bound_by": main_f32["bound_by"],
        "library_ms": main_f32["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
