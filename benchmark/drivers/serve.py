"""Checkpoint serving: one client scoring requests of windows with a loaded
model, each request sent when the last is answered (a closed loop).

Set-up makes the configuration's widest model's weights on the card from
the seed (one draw for all leaves, cut and scaled per leaf: U(-1/sqrt(fan
in), 1/sqrt(fan in)) as the port inits, BatchNorm's affine and running
moments near 1 and 0), saves them as an npz checkpoint in a temporary
directory, loads it with the port's ``load_model`` and draws a pool of
distinct requests from the seed; one request warms the micro-batch shape.
The window sends pool requests in a seeded order through
``ReloadedModel.__call__`` (host arrays in, probabilities on the host out)
and times each.  After it the reference scores a seeded sample of the
answered requests from the same weights.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from benchmark.frozen import arch as A
from benchmark.frozen.data import make_data
from benchmark.frozen.flops import PEAK_FLOPS, fwd_flops
from benchmark.reference import multimodal as M
from benchmark.reference.precision import exact


def _weights(a: dict, in_features: int, seed: int, device):
    """``(params, bn_state)`` full-layout trees of the model, on
    ``device``."""
    import torch

    layout = M.full_layout(a, in_features)
    bn = [(i, c) for i, c in enumerate(A.CNN_MAX_CHANNELS)]
    total = sum(int(np.prod(s)) for _, s, _ in layout) \
        + 4 * sum(c for _, c in bn)
    gen = torch.Generator(device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device)
    params, bn_state, at = {}, {}, 0

    def cut(shape):
        nonlocal at
        n = int(np.prod(shape))
        at += n
        return u[at - n:at].view(shape)

    def put(tree, name, value):
        parts = name.split(".")
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value

    for name, shape, fan in layout:
        put(params, name, (cut(shape) * 2.0 - 1.0) / max(float(fan), 1.0) ** 0.5)
    for i, c in bn:
        put(params, f"cnn.bn{i}.scale", 0.9 + 0.2 * cut((c,)))
        put(params, f"cnn.bn{i}.bias", 0.2 * cut((c,)) - 0.1)
        bn_state[f"bn{i}"] = {"mean": 0.2 * cut((c,)) - 0.1,
                              "var": 0.5 + cut((c,))}
    return params, bn_state


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


def setup(ctx) -> dict:
    import torch

    from embracenet_tpu_torch.models.reload import load_model
    from embracenet_tpu_torch.training.checkpoint import save_checkpoint

    cfg, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    model, F = cfg["model"], cfg["in_features"]
    a = A.arch(model, cfg["widest"])
    params, bn_state = _weights(a, F, ctx["seed"], dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        save_checkpoint(path, {"params": _numpy(params),
                               "bn_state": _numpy(bn_state)},
                        meta={"model": model, "model_params": cfg["widest"]})
        served = load_model(path, device=dev)
    rng = np.random.default_rng(ctx["seed"])
    n = mix["request_windows"]
    pool = [make_data(n, F, rng) for _ in range(mix["pool"])]
    pool = [{"ffnn": p["ffnn"], "cnn": p["cnn"]} for p in pool]
    served(pool[0])
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"arch": a, "params": params, "bn_state": bn_state,
            "model": served, "pool": pool, "rng": rng}


def window(ctx, st, seconds: float) -> dict:
    order = st["rng"].permutation(len(st["pool"]))
    lat, answers, failed = [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        k = int(order[len(lat) % len(order)])
        t = time.perf_counter()
        probs = st["model"](st["pool"][k])
        lat.append(time.perf_counter() - t)
        answers.append((k, probs))
        n = len(st["pool"][k]["ffnn"])
        failed += not (probs.shape == (n, 2) and np.isfinite(probs).all())
    wall = time.perf_counter() - t0
    st["answers"] = answers
    windows = sum(len(p) for _, p in answers)
    lat = sorted(lat)
    p95 = lat[max(0, int(np.ceil(0.95 * len(lat))) - 1)]
    return {"attempted": len(lat), "failed": failed, "wall_s": wall,
            "metrics": {"serve_windows_per_s": windows / wall,
                        "serve_p95_ms": 1e3 * p95},
            "useful_flops": windows * fwd_flops(st["arch"],
                                                ctx["config"]["in_features"]),
            "peak_flops": PEAK_FLOPS[ctx["traffic"]["compute_dtype"]],
            "detail": {"requests": len(lat), "median_ms": 1e3 * lat[len(lat) // 2]}}


def stretch(ctx, st) -> dict:
    """A few more requests under the profiler -> how many, and the fused
    kernel's launches by shape."""
    import torch

    mix, a = ctx["traffic"], st["arch"]
    for i in range(mix["traced_requests"]):
        with torch.profiler.record_function("bench.request"):
            st["model"](st["pool"][i % len(st["pool"])])
    batch = st["model"].BATCH
    n_batches = -(-mix["request_windows"] // batch)
    launches = []
    if a["model"] == A.EMBRACENET:
        bk = A.buckets([a], True)
        launches.append((mix["traced_requests"] * n_batches, 1, batch, bk["W"],
                         bk["D1"], bk["EB"], mix["compute_dtype"]))
    return {"requests": mix["traced_requests"], "launches": launches}


def reference_probs(ctx, st, k: int, precision: str):
    """The reference's class probabilities for pool request ``k``,
    4,096 rows at a time (the embracement's rows restart with each of the
    port's micro-batches, which the draw follows)."""
    import torch

    dev, a = ctx["device"], st["arch"]
    P = M.live_leaves(st["params"], a, M.full_bucket(a))
    stats = {i: {s: v[:c] for s, v in st["bn_state"][f"bn{i}"].items()}
             for i, c in enumerate(a["cnn_channels"])}
    req, batch, out = st["pool"][k], st["model_batch"], []
    with torch.no_grad(), exact():
        for lo in range(0, len(req["ffnn"]), batch):
            x = torch.as_tensor(req["ffnn"][lo:lo + batch], device=dev)
            c = torch.as_tensor(req["cnn"][lo:lo + batch], device=dev)
            logits = M.forward(a, P, x, c, None, precision, bn_stats=stats,
                               eval_key=ctx["traffic"]["eval_key"],
                               cpu_draw=dev == "cpu")
            out.append(torch.softmax(logits, -1).cpu().numpy())
    return np.concatenate(out)


def sample(ctx, st) -> list:
    """A seeded sample of the answered requests, of distinct pool items."""
    rng = np.random.default_rng(ctx["seed"] + 1)
    first = {}
    for i, (k, _) in enumerate(st["answers"]):
        first.setdefault(k, i)
    picks = sorted(first.values())
    n = min(ctx["traffic"]["checked_requests"], len(picks))
    return [st["answers"][i] for i in rng.choice(picks, n, replace=False)]


def check(ctx, st, win) -> dict:
    import torch

    picked = sample(ctx, st)
    st["model_batch"] = st["model"].BATCH
    del st["model"], st["answers"]
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()
    gap, where = 0.0, None
    for k, probs in picked:
        d = float(np.abs(probs - reference_probs(
            ctx, st, k, ctx["traffic"]["compute_dtype"])).max())
        if not d <= gap:
            gap, where = d, f"request of pool item {k}"
    return {"prob_gap": gap}, {"prob_gap": where}
