"""What the card-side scripts share: the H100 peak rates and the fused
forward's bound, CUDA-event timing (eager, and of a replayed CUDA
graph), the card's ``nvidia-smi`` line, the widest model of each family,
and the learnable data and raw data files they drive.

Used by ``chip_smoke.py``, ``tools/torch_embrace_bench.py``,
``tools/torch_serve_profile.py`` and the port's tests; nothing in the
training or serving path imports it.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from embracenet_tpu_torch.config import (CNN_CHANNEL_MENUS, CNN_KERNEL_MENU,
                                         CNN_LSTM_HIDDEN_MENU,
                                         CNN_LSTM_MAX_LSTM_LAYERS,
                                         CONCAT_POST_WIDTH_MENUS,
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


def widest_concat_flat_params() -> dict:
    """The widest ConcatNetMultimodal of the search space: the FFNN and CNN
    branches of :func:`widest_flat_params`, 3 post layers of 1024 / 512 /
    256, Adam lr 1e-3."""
    flat = {k: v for k, v in widest_flat_params(0.5).items()
            if k.startswith(("FFNN_", "CNN_")) or k in ("optimizer", "lr",
                                                        "weight_decay")}
    flat["CONCATNET_n_post_layers"] = len(CONCAT_POST_WIDTH_MENUS)
    for i, menu in enumerate(CONCAT_POST_WIDTH_MENUS):
        flat[f"CONCATNET_n_units_l{i}"] = max(menu)
    return flat


def widest_lstm_flat_params() -> dict:
    """The widest CNN_LSTM of the search space: one conv block of 64
    channels (the most timesteps: 64 * 124 / 4 = 1,984) with 15 taps, an
    LSTM of 2 layers of hidden size 128, Adam lr 1e-3."""
    return {"n_layers": 1, "out_channels_l0": max(CNN_CHANNEL_MENUS[0]),
            "kernel_size_l0": max(CNN_KERNEL_MENU),
            "LSTM_hidden_layer_size": max(CNN_LSTM_HIDDEN_MENU),
            "LSTM_n_layers": CNN_LSTM_MAX_LSTM_LAYERS,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}


def write_raw_dataset(root: str, n_regions, widths: dict, seed: int = 0,
                      prevalence: float = 0.3, nan_columns: int = 3,
                      nan_share: float = 0.02) -> None:
    """Write a raw data tree in the reference's layout:
    ``root/{enhancers,promoters}/`` each with a ``<CELL>.csv`` per cell line
    of ``widths`` (cell -> feature count), one ``.bed`` of labels and one
    sequence-first ``.fa`` of 256-bp windows; ``n_regions`` counts the
    regions of each family (an int, or a pair: enhancers, promoters).

    Features are N(0, 1), written with 10 significant digits, with a label
    shift of 0.1-0.5 in 60 % of the columns, a near copy of column 0 in
    column 1 (for the redundancy filter), and ``nan_share`` of the cells of
    ``nan_columns`` columns missing, written alternately empty and ``NA``
    (so imputation runs).
    Sequences mix lower- and upper-case bases with 1 % ``n``."""
    rng = np.random.default_rng(seed)
    counts = (n_regions, n_regions) if np.isscalar(n_regions) else n_regions
    for family, n in zip(("enhancers", "promoters"), counts):
        d = os.path.join(root, family)
        os.makedirs(d, exist_ok=True)
        start = np.arange(n) * 300
        labels = {}
        for cell, width in widths.items():
            y = (rng.random(n) < prevalence).astype(np.int64)
            x = rng.normal(size=(n, width))
            n_signal = int(0.6 * width)
            x[:, :n_signal] += np.outer(y, rng.uniform(0.1, 0.5, n_signal))
            x[:, 1] = 1.5 * x[:, 0] + 0.01 * rng.normal(size=n)
            missing = {}           # row -> {column: the cell's text}
            for j in range(2, 2 + min(nan_columns, width - 2)):
                rows = np.flatnonzero(rng.random(n) < nan_share)
                for k, i in enumerate(rows):
                    missing.setdefault(i, {})[j] = "NA" if k % 2 else ""
            row_fmt = ",".join(["%.10g"] * width)
            with open(os.path.join(d, f"{cell}.csv"), "w") as fh:
                fh.write(",".join(["chrom", "chromStart", "chromEnd", "strand"]
                                  + [f"f{j}" for j in range(width)]) + "\n")
                for i in range(n):
                    if i in missing:
                        cells = ["%.10g" % v for v in x[i]]
                        for j, text in missing[i].items():
                            cells[j] = text
                        values = ",".join(cells)
                    else:
                        values = row_fmt % tuple(x[i])
                    fh.write(f"chr1,{start[i]},{start[i] + 256},+,{values}\n")
            labels[cell] = y
        with open(os.path.join(d, f"{family}.bed"), "w") as fh:
            fh.write("\t".join(["chrom", "chromStart", "chromEnd", *labels])
                     + "\n")
            for i in range(n):
                fh.write("\t".join([f"chr1\t{start[i]}\t{start[i] + 256}"]
                                   + [str(v[i]) for v in labels.values()])
                         + "\n")
        bases = np.frombuffer(b"acgtACGTn", np.uint8)
        p = np.r_[np.full(4, 0.2), np.full(4, 0.0475), 0.01]
        seqs = rng.choice(bases, size=(n, 256), p=p / p.sum())
        with open(os.path.join(d, f"{family}.fa"), "w") as fh:
            for i in range(n):
                fh.write(seqs[i].tobytes().decode() + "\n")
                fh.write(f">chr1:{start[i]}-{start[i] + 256}\n")
