"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything it
needs is found by name: its configuration's file (``configs/``), its
traffic mix (``traffic/<mix>.json``, which names its driver in
``drivers/``), its limits (``limits/<cell>.json``) and, with ``--trace
1``, one reader a per-layer metric (``metrics/<metric>.py``).  This file
holds no cell, configuration or metric of its own.

A run sets up (the set-up time counts from the process's start to the
window's), measures for ``--seconds``, profiles a short stretch after the
window when ``--trace 1``, reads the device's memory peak, then checks
what the window produced against the plain reference.  It needs as many
CUDA cards as the cell names and never falls back to the CPU.  It prints
each compared number beside its limit as its last lines on standard
error, and one JSON object as its last line on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "embracenet_tpu")


def load_module(path: Path, name: str):
    """Import the file at ``path`` under ``name`` (metric files have dots
    in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything a cell needs, found by name from ``BENCHMARK.json``: its
    workload entry, configuration, traffic mix, driver, limits and the
    per-layer metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    here = root / "benchmark"
    conf_file = root / files[work["config"]]
    traffic = json.loads((here / "traffic" / f"{work['traffic']}.json").read_text())

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "workload": work,
        "config": json.loads(conf_file.read_text()),
        "traffic": traffic,
        "driver": here / "drivers" / f"{traffic['driver']}.py",
        "limits": json.loads((here / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "metric_files": {m["name"]: here / "metrics" / f"{m['name']}.py"
                         for m in bench["per_layer"] if reports(m)},
    }


def power_limit():
    """The first card's power limit as ``nvidia-smi`` reads it (a card set
    below its 700 W runs slower under load), or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(c: dict, rec: dict) -> dict:
    """Each per-layer metric's reader over the traced records; a reader
    that finds nothing to read gives None and its metric is left out."""
    out = {}
    for m in c["per_layer"]:
        mod = load_module(c["metric_files"][m["name"]],
                          "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float = T_START) -> tuple:
    """One run of cell ``c`` -> ``(result dict, check lines)``."""
    import torch

    from benchmark.core import checks, trace as tr

    ctx = {"workload": c["workload"], "config": c["config"],
           "traffic": c["traffic"], "seed": seed, "device": device}
    driver = load_module(c["driver"], "bench_driver_" + c["traffic"]["driver"])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    st = driver.setup(ctx)
    setup_s = time.perf_counter() - t_start
    win = driver.window(ctx, st, seconds)
    result = {"attempted": win["attempted"], "failed": win["failed"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": c["workload"]["chips"]}
    if trace:
        counts, rec = tr.profile(lambda: driver.stretch(ctx, st))
        rec.update(counts)
        rec["window"] = win
        metrics = per_layer(c, rec)
        device_info["busy_s"] = tr.busy_seconds(rec)
        device_info["window_s"] = rec["stretch_s"]
        result["breakdown"] = tr.breakdown(rec)
    else:
        metrics = {}
        values = dict(win["metrics"], setup_s=setup_s)
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                        if cuda else 0)
    if cuda:
        device_info["power_limit"] = power_limit()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"run.py: the run loaded {', '.join(found)}")
    values, where = driver.check(ctx, st, win)
    correct, compared = checks.verdict(values, c["limits"])
    lines = [f"window: {json.dumps(win.get('detail', {}))}; set-up "
             f"{setup_s!r} s"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r}; worst at "
             f"{where.get(k)})" for k, v in compared.items()]
    result.update(correct=correct and win["failed"] == 0, metrics=metrics,
                  device=device_info, checks=compared)
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = HERE / "out"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(out / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(out / "triton")
    c = cell(args.workload)
    import torch

    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run(c, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    # the checks come last in the result line, and last on standard error
    result["checks"] = result.pop("checks")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
