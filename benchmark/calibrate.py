"""Readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... [--device cuda]

For each seed it makes the cell's set-up and reads what ``correct``
compares, without a measured window (the numbers a run compares do not
depend on it):

* training cells: the first stacked steps of every group's fit (the fit
  stopped after them), then the gaps of the program, of the control (the
  reference at the precision below the cell's, ``control_precision`` in
  the traffic mix) and of the fault "half of each batch left out" (the
  reference put in the program's place), each against the reference at
  the cell's precision; the loss gap also step by step; and of the fault
  "one trial's learning rate 1.1 times its own" (the first group's last
  trial), which only a per-trial number sees;
* serving cells: the answers to the checked requests, then the gaps of the
  program and of the control against the reference.

Prints one JSON line per seed and a last line with each number's largest
reading over the seeds (the program's) and smallest (the control's and
the fault's).  Not a benchmark run: it times nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark.core.checks import train_gaps  # noqa: E402
from benchmark.run import cell, load_module  # noqa: E402


class _Stop(Exception):
    pass


def _train_seed(driver, ctx) -> dict:
    import torch

    st = driver.setup(ctx)
    engine = st["engine"]
    cap = driver.Capture(engine.population_step)

    def stop_after(*args, **kwargs):
        out = cap(*args, **kwargs)
        if len(cap.fits[-1]["loss"]) == driver.STEPS:
            raise _Stop
        return out

    engine.population_step = stop_after
    try:
        for g in range(len(st["groups"])):
            cap.begin()
            try:
                driver._fit(ctx, st, g, st["train"], st["val"])
            except _Stop:
                pass
    finally:
        engine.population_step = cap.step_fn
    st["capture"] = cap
    port = driver._port_side(st)
    del st["capture"], cap
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()
    mix = ctx["traffic"]
    ref = driver.reference(ctx, st, mix["compute_dtype"])
    out = {}
    for name, side in (("program", port),
                       ("control", driver.reference(ctx, st,
                                                    mix["control_precision"])),
                       ("half", driver.reference(ctx, st, mix["compute_dtype"],
                                                 fault="half")),
                       ("one_trial_lr", driver.reference(
                           ctx, st, mix["compute_dtype"], fault="lr"))):
        gaps = train_gaps(side, ref)
        out[name] = {k: v[0] for k, v in gaps.items()}
        out[name]["where"] = {k: v[1] for k, v in gaps.items()}
        out[name]["loss_gap_by_step"] = [
            max(abs(p["loss"][s] - r["loss"][s]) / abs(r["loss"][s])
                for pg, rg in zip(side, ref) for p, r in zip(pg, rg))
            for s in range(driver.STEPS)]
    return out


def _serve_seed(driver, ctx) -> dict:
    import numpy as np

    st = driver.setup(ctx)
    n = ctx["traffic"]["checked_requests"]
    answers = [(k, st["model"](st["pool"][k])) for k in range(n)]
    st["model_batch"] = st["model"].BATCH
    del st["model"]
    out = {}
    for name, precision in (("program", None),
                            ("control", ctx["traffic"]["control_precision"])):
        gap = 0.0
        for k, probs in answers:
            ref = driver.reference_probs(ctx, st, k, ctx["traffic"]
                                         ["compute_dtype"])
            side = probs if precision is None else driver.reference_probs(
                ctx, st, k, precision)
            gap = max(gap, float(np.abs(side - ref).max()))
        out[name] = {"prob_gap": gap}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    c = cell(args.workload)
    driver = load_module(c["driver"], "bench_driver_" + c["traffic"]["driver"])
    read = _train_seed if hasattr(driver, "Capture") else _serve_seed
    worst: dict = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = {"workload": c["workload"], "config": c["config"],
               "traffic": c["traffic"], "seed": seed, "device": args.device}
        out = read(driver, ctx)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for side, nums in out.items():
            for k, v in nums.items():
                if isinstance(v, float):
                    pick = max if side == "program" else min
                    key = f"{side}.{k}"
                    worst[key] = pick(worst.get(key, v), v)
    print(json.dumps({"workload": args.workload, "readings": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
