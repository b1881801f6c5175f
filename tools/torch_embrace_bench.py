"""The fused docking + embracement kernels against the unfused path on the
CUDA card: the PyTorch port of ``tools/pallas_bench.py``.

    python3 tools/torch_embrace_bench.py [--iters 20] [--out FILE]

``block_bench`` times the block in isolation at D0=256, D1=7936, E=1024
with bf16 operands: the unfused forward (two cuBLAS products, ReLU,
select), the tiled kernel (``fused_embrace``), the full-E kernel
(``fused_embrace_fulle``), and the unfused and fused forward + backward
with gradients w.r.t. w0 and w1.  Times come from CUDA events after a
warm-up, per call.  The roofline uses the H100 SXM data-sheet peaks
(dense) of ``embracenet_tpu_torch/benchkit.py``: 67 TFLOP/s CUDA-core
float32, 989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM3.  ``engine_bench`` times ``engine.fit`` with the fused
kernel on or off (n=4000, d=64, one CNN layer, E=1024, batch 1024, bf16,
10 epochs; the second of two fits is timed).

``train_profile`` runs one epoch of ``engine.fit``
on the widest EmbraceNetMultimodal at batch 100 (``chip_smoke.py``'s train
phase model and data, 1,000 windows), fused and unfused, under
``torch.profiler``: device time by kernel family, kernel launches per
train step, and the device's busy share of the fit's wall.

Prints one JSON line per block size and per engine run, each with the
card's ``nvidia-smi`` name and power limit; writes them to ``--out`` only
when given.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from embracenet_tpu_torch.benchkit import (IN_FEATURES, bound,  # noqa: E402
                                           cuda_ms, make_data, nvidia_smi,
                                           widest_flat_params)
from embracenet_tpu_torch.models.embracenet import embrace  # noqa: E402
from embracenet_tpu_torch.models.layers import linear  # noqa: E402
from embracenet_tpu_torch.ops import embrace as K  # noqa: E402

BLOCK_SIZES = (100, 256, 1280, 4096)


def _card():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_embrace_bench needs a CUDA card")
    return torch.device("cuda")


def block_bench(B, D0=256, D1=7936, E=1024, seed=0, iters=20,
                dtype=torch.bfloat16):
    """One row of the block table (ms per call) at batch ``B``."""
    dev = _card()
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32) * scale,
                               device=dev)

    x0, x1 = arr(B, D0), arr(B, D1)
    w0, w1 = arr(D0, E, scale=0.02), arr(D1, E, scale=0.02)
    b0, b1 = torch.zeros(E, device=dev), torch.zeros(E, device=dev)
    p0 = torch.full((B,), 0.5, device=dev)
    em = torch.ones(E, device=dev)
    p = torch.stack([p0, 1 - p0], -1)
    gen = torch.Generator(device=dev).manual_seed(0)

    def unfused_once(w0, w1):
        d0 = torch.relu(linear(x0, w0, b0, dtype)) * em
        d1 = torch.relu(linear(x1, w1, b1, dtype)) * em
        return embrace([d0, d1], gen, selection_probabilities=p, e_mask=em)

    def fused_once(w0, w1, kernel=K.fused_embrace):
        return kernel(x0.to(dtype), x1.to(dtype), w0.to(dtype), b0,
                      w1.to(dtype), b1, p0, em, 7)[0]

    def fwd(once, **kw):
        def run():
            with torch.no_grad():
                once(w0, w1, **kw)
        return run

    def fwd_bwd(once):
        lw0 = w0.clone().requires_grad_(True)
        lw1 = w1.clone().requires_grad_(True)

        def run():
            out = once(lw0, lw1)
            torch.autograd.grad((out ** 2).sum(), (lw0, lw1))
        return run

    row = {"B": B, "D0": D0, "D1": D1, "E": E, "operands": str(dtype).split(".")[-1],
           "iters": iters,
           "fwd_unfused_ms": cuda_ms(fwd(unfused_once), iters),
           "fwd_fused_ms": cuda_ms(fwd(fused_once), iters),
           "fwd_fulle_ms": cuda_ms(fwd(fused_once, kernel=K.fused_embrace_fulle),
                                   iters),
           "bwd_unfused_ms": cuda_ms(fwd_bwd(unfused_once), iters),
           "bwd_fused_ms": cuda_ms(fwd_bwd(fused_once), iters)}
    row["fwd_speedup"] = row["fwd_unfused_ms"] / row["fwd_fused_ms"]
    row["fwd_fulle_speedup"] = row["fwd_unfused_ms"] / row["fwd_fulle_ms"]
    row["bwd_speedup"] = row["bwd_unfused_ms"] / row["bwd_fused_ms"]
    bound_ms, by, flops, nbytes = bound(B, D0, D1, E, dtype)
    row["roofline"] = {"flops": flops, "bytes": nbytes, "bound": by,
                       "bound_ms": bound_ms,
                       "fwd_unfused_x_bound": row["fwd_unfused_ms"] / bound_ms,
                       "fwd_fused_x_bound": row["fwd_fused_ms"] / bound_ms,
                       "fwd_fulle_x_bound": row["fwd_fulle_ms"] / bound_ms}
    return row


def engine_bench(fused: bool, n=4000, epochs=10, batch=1024):
    """Train windows/s of ``engine.fit`` on the card (second of two fits)."""
    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.hpo import space
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.modelspec import get_spec

    _card()
    rng = np.random.default_rng(0)
    d = 64
    y = (rng.random(n + 500) < 0.2).astype(np.int64)
    data = {"ffnn": rng.normal(size=(n + 500, d)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(n + 500, 256)).astype(np.uint8),
            "y": y}
    train = {k: v[:n] for k, v in data.items()}
    test = {k: v[n:] for k, v in data.items()}
    flat = space.sample_params("EmbraceNetMultimodal", np.random.default_rng(3))
    flat.update(CNN_n_layers=1, EMBRACENET_embracement_size=1024)
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    opt = space.optimizer_hp(flat)
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=d)
    cfg = TrainConfig(num_epochs=epochs, epoch_chunk=epochs, batch_size=batch,
                      compute_dtype="bfloat16", patience=10_000,
                      fused_embrace=fused)
    engine.fit(spec, [hp], [opt], train, test, cfg)
    launches0 = K.LAUNCHES
    t0 = time.perf_counter()
    res = engine.fit(spec, [hp], [opt], train, test, cfg)
    dt = time.perf_counter() - t0
    ep = len(res.auprc_test[0])
    return {"fused": fused, "seconds": dt, "epochs": ep,
            "windows_per_s": n * ep / dt, "kernel_launches": K.LAUNCHES - launches0,
            "best_test_auprc": max(res.auprc_test[0])}


def train_profile(fused: bool, compute_dtype=None, n_train=1000, batch=100):
    """Device time of one epoch of ``engine.fit`` on the widest model, by
    kernel family (``tools/torch_serve_profile.py``'s), with the kernel
    count per train step and the busy share (summed kernel time over the
    unprofiled fit's wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torch_serve_profile import device_times
    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.hpo import space
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
    from embracenet_tpu_torch.training.modelspec import get_spec

    _card()
    data = make_data(n_train + 200, IN_FEATURES, np.random.default_rng(0))
    train = {k: v[:n_train] for k, v in data.items()}
    test = {k: v[n_train:] for k, v in data.items()}
    flat = widest_flat_params(0.5)
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    cfg = TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=batch,
                      compute_dtype=compute_dtype or "float32",
                      fused_embrace=fused)

    def run():
        engine.fit(spec, [hp], [space.optimizer_hp(flat)], train, test, cfg)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    dev_ms = device_times(prof)
    n_kernels = sum(evt.count for evt in prof.key_averages()
                    if evt.device_type == DeviceType.CUDA)
    steps = balanced_plan(train["y"], batch, seed=123).idx.shape[0]
    evals = eval_plan(len(test["y"]), 2 * batch, seed=123).idx.shape[0]
    total = sum(dev_ms.values())
    return {"fused": fused, "compute_dtype": compute_dtype or "float32",
            "train_steps": steps, "eval_batches": evals, "fit_wall_s": wall,
            "ms_per_train_step": 1e3 * wall / steps,
            "device_ms": dev_ms, "device_ms_total": total,
            "busy_share": total / 1e3 / wall,
            "kernels_per_train_step": n_kernels / steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    card = nvidia_smi()
    lines = []
    for B in BLOCK_SIZES:
        lines.append({"block": block_bench(B, iters=args.iters), "card": card})
        print(json.dumps(lines[-1]), flush=True)
    engine_rows = {f: engine_bench(f) for f in (False, True)}
    for f in (False, True):
        lines.append({"engine": engine_rows[f], "card": card})
        print(json.dumps(lines[-1]), flush=True)
    summary = {"engine_speedup": engine_rows[True]["windows_per_s"]
               / engine_rows[False]["windows_per_s"], "card": card}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    for fused in (True, False):
        lines.append({"train_profile": train_profile(fused), "card": card})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
