"""A population's initial parameters drawn on the card by the MT19937 kernel
(``engine.init_population`` → ``ops/mt19937.uniform_init``) against the
host draw it replaces, at the benchmark's two training populations.

    python3 tools/torch_init_draws_bench.py [--seed N] [--reps 5] [--out FILE]

For ``embracenet-hepg2``'s 8 supernet trials (one launch, 8 streams, as
one ``engine.fit`` of the pop8 cell) and for each of ``cnn_lstm-hepg2``'s 8
architectures (a fit of one trial, one stream, as the search fits them) it
prints one JSON line:

* ``words_per_stream``: the numbers one trial draws;
* ``kernel_ms``: ``uniform_init`` alone (its table copy and its launch),
  CUDA events, the median of ``--reps`` calls after one that warms the
  allocator; ``words_per_s_per_stream``
  = ``words_per_stream`` over it;
* ``init_ms``: ``engine.init_population`` on the host's clock to a
  synchronise (the plan, the launch, the constants' copies): what a fit's
  set-up pays on the card, median of ``--reps``; ``init_device_draws``:
  what one call adds to the ``engine.init_device_draws`` counter;
  ``launches``: the kernel's launches over all those calls (two a rep)
  and one more under ``torch.profiler``, whose device time of the kernel
  alone is ``device_ms`` (None where the profiler sees no device time);
  ``bound_ms``: the leaves' bytes, written once, over the card's memory
  rate;
* ``host_s``: the host draw and stack that the card replaces
  (``engine.host_init``: every trial's CPU generator, trial by trial),
  ``plain_ms`` the same in ms, and ``host_copy_s``: the copy of its tree
  to the card from pageable memory;
* ``equal``: the card's leaves are the host's bit for bit.

Seeds as the benchmark's fits take them: ``seed_streams(seed, 8)`` for the
pop8 population, ``seed_streams(seed + 7919 g, 1)`` for architecture g.
Ends with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from embracenet_tpu_torch.benchkit import PEAK_BYTES, nvidia_smi  # noqa: E402
from embracenet_tpu_torch.convert import tree_leaves  # noqa: E402
from embracenet_tpu_torch.hpo import space  # noqa: E402
from embracenet_tpu_torch.models.layers import InitPlan  # noqa: E402
from embracenet_tpu_torch.ops import mt19937  # noqa: E402
from embracenet_tpu_torch.training import engine  # noqa: E402
from embracenet_tpu_torch.training.modelspec import get_spec  # noqa: E402
from embracenet_tpu_torch.utils.profiling import counters  # noqa: E402


def population(config: str):
    """A benchmark configuration's (spec, hps)."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    return (get_spec(cfg["model"], cfg["in_features"]),
            [space.params_to_hp(cfg["model"], p) for p in cfg["population"]])


def case(name, spec, hps, seeds, dev, reps) -> dict:
    plans = [InitPlan() for _ in hps]
    for plan, hp in zip(plans, hps):
        spec.init(plan, hp)
    shapes, bounds = plans[0].shapes, [p.bounds for p in plans]
    words = sum(int(torch.Size(s).numel()) for s in shapes)
    kernel, init, got = [], [], None
    launched = counters().get("mt19937.launches", 0)
    for _ in range(reps + 1):       # the first call warms the allocator
        got = None
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = mt19937.uniform_init(shapes, bounds, seeds, dev)
        stop.record()
        torch.cuda.synchronize()
        kernel.append(start.elapsed_time(stop))
        del out
        before = counters().get("engine.init_device_draws", 0)
        t0 = time.perf_counter()
        got = engine.init_population(spec, hps, seeds, dev)
        torch.cuda.synchronize()
        init.append((time.perf_counter() - t0) * 1e3)
        drawn = counters()["engine.init_device_draws"] - before
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = mt19937.uniform_init(shapes, bounds, seeds, dev)
        torch.cuda.synchronize()
    del out
    device_us = sum(getattr(e, "device_time_total", 0)
                    for e in prof.key_averages() if "mt19937" in e.key)
    t0 = time.perf_counter()
    want = engine.host_init(spec, hps, seeds)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    copied = [a.to(dev, copy=True) for a in tree_leaves(want)]
    torch.cuda.synchronize()
    host_copy_s = time.perf_counter() - t0
    del copied
    equal = all(torch.equal(a.cpu(), b) for a, b in
                zip(tree_leaves(got), tree_leaves(want)))
    launched = counters()["mt19937.launches"] - launched
    kernel, init = kernel[1:], init[1:]
    kernel_ms = statistics.median(kernel)
    return {"case": name, "trials": len(hps), "words_per_stream": words,
            "kernel_ms": kernel_ms, "kernel_ms_all": kernel,
            "words_per_s_per_stream": words / (kernel_ms / 1e3),
            "device_ms": device_us / 1e3 if device_us else None,
            "bound_ms": 1e3 * 4 * words * len(hps) / PEAK_BYTES,
            "init_ms": statistics.median(init), "init_device_draws": drawn,
            "launches": launched,
            "host_s": host_s, "plain_ms": host_s * 1e3,
            "host_copy_s": host_copy_s, "equal": equal,
            "seeds": [int(s) for s in seeds]}


def run(dev, seed: int, reps: int = 5, byarch=range(8)) -> list:
    """The pop8 case, then architecture g of CNN_LSTM for g in ``byarch``."""
    spec, hps = population("embracenet-hepg2")
    out = [case("embracenet-hepg2.pop8", spec, hps,
                engine.seed_streams(seed, len(hps))[0], dev, reps)]
    spec, hps = population("cnn_lstm-hepg2")
    for g in byarch:
        out.append(case(f"cnn_lstm-hepg2.trial{g}", spec, hps[g:g + 1],
                        engine.seed_streams(seed + 7919 * g, 1)[0], dev,
                        reps))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2100000001)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_init_draws_bench: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi()
    rows = run(dev, args.seed, args.reps)
    for row in rows:
        print(json.dumps(dict(row, card=card)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card, flush=True)
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
