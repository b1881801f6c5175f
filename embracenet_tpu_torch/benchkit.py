"""What the card-side scripts share: the H100 peak rates and the fused
forward's bound, CUDA-event timing (eager, and of a replayed CUDA
graph), the card's ``nvidia-smi`` line, and the widest model and
learnable data they drive.

Used by ``chip_smoke.py``, ``tools/torch_embrace_bench.py`` and
``tools/torch_serve_profile.py``; nothing in the training or serving path
imports it.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from embracenet_tpu_torch.config import (CNN_CHANNEL_MENUS, CNN_KERNEL_MENU,
                                         EMBRACE_POST_WIDTH_MENUS,
                                         FFNN_WIDTH_MENUS, EMBRACE_SIZE_MENU)

# H100 SXM data-sheet peaks (dense): CUDA-core float32, bf16 tensor cores, HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
IN_FEATURES = 566        # HEPG2, the widest cell line


def nvidia_smi() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events, after
    ``warmup`` calls."""
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


def graph_ms(fn, iters=20, warmup=3) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, timed with CUDA events, so the host's time
    between launches does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(B, D0, D1, E, dtype):
    """Least time the card could take for the fused forward: operations
    over the peak rate of their type, or each input read once and each
    output written once over the memory rate, whichever is larger ->
    ``(ms, "operations" | "bytes", flops, bytes)``."""
    item = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * B * (D0 + D1) * E
    nbytes = (item * (B * D0 + B * D1 + D0 * E + D1 * E)   # x0 x1 w0 w1
              + 4 * (3 * E + B)                            # b0 b1 e_mask p0
              + 4 * B * E + B * E)                         # out, choose
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def make_data(n, d, rng, prevalence=0.15):
    """``bench.py``'s learnable synthetic windows (``prevalence``: the share
    of positives, ``bench.py``'s 0.15 by default)."""
    y = (rng.random(n) < prevalence).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w) * 0.5).astype(np.float32)
    codes = rng.integers(0, 4, size=(n, 256)).astype(np.uint8)
    return {"ffnn": x, "cnn": codes, "y": y}


def widest_flat_params(p_ffnn: float) -> dict:
    """The widest EmbraceNetMultimodal of the search space (every menu's
    maximum), Adam lr 1e-3, at selection probability ``p_ffnn``."""
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
