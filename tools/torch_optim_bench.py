"""The population's optimizer update by the fused kernel
(``ops/optim.apply_update`` on the card → ``fused_update``,
``csrc/optim_update.cu``) against its plain version
(``ops/optim.apply_update_reference``), at the benchmark's pop8 population.

    python3 tools/torch_optim_bench.py [--seed N] [--reps 20] [--out FILE]

The 8 supernet trials of ``embracenet-hepg2`` (34 leaves, 95.66 M numbers,
drawn as a fit draws them, with the population's own optimizers and
rates), in three types: float32 params and state (``train()``'s
defaults), bf16 m and v (``optim_dtype="bfloat16"``), bf16 params with a
float32 master (``param_dtype="bfloat16"``).  One JSON line a type:

* ``equal``: three chained steps from the same state, the second with
  trial 3 frozen, one leaf's gradient None: the kernel's params, m, v,
  master, ``step`` and ``m_schedule`` are the plain version's bit for
  bit, and its inputs are left as they were;
* ``launches``: ``optim.launches`` a call;
* ``ms`` / ``plain_ms``: one ``apply_update`` / ``apply_update_reference``
  call (its coefficient math, allocations and launches), CUDA events over
  ``--reps`` calls after warm-up;
* ``device_ms``: the kernel's own device time a launch under
  ``torch.profiler``, over the launches it recorded (None where it sees
  no device time);
* ``bytes``: what the update must move (each leaf's params or master,
  gradient, m and v read once; params, m, v and master written once);
  ``bound_ms`` those bytes at 3.35 TB/s; ``roofline_pct`` the bound over
  ``device_ms``.

Ends with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from embracenet_tpu_torch.benchkit import PEAK_BYTES, cuda_ms, nvidia_smi  # noqa: E402
from embracenet_tpu_torch.convert import (tree_leaves, tree_map,  # noqa: E402
                                          tree_unflatten)
from embracenet_tpu_torch.hpo import space  # noqa: E402
from embracenet_tpu_torch.ops import optim  # noqa: E402
from embracenet_tpu_torch.training import engine  # noqa: E402
from embracenet_tpu_torch.training.modelspec import get_spec  # noqa: E402
from embracenet_tpu_torch.utils.profiling import counters  # noqa: E402

# the state's dtype and whether a float32 master keeps bf16 params' truth
TYPES = {"float32": (None, False), "bf16_state": (torch.bfloat16, False),
         "bf16_master": (None, True)}


def pop8(dev, seed: int):
    """``embracenet-hepg2``'s population: its params stacked over the 8
    trials, drawn on ``dev``, and its ``opt_hp`` ([T] tensors)."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           "embracenet-hepg2.json")) as f:
        cfg = json.load(f)
    spec = get_spec(cfg["model"], cfg["in_features"])
    hps = [space.params_to_hp(cfg["model"], p) for p in cfg["population"]]
    opts = [space.optimizer_hp(p) for p in cfg["population"]]
    seeds, _ = engine.seed_streams(seed, len(hps))
    params, _ = engine.init_population(spec, hps, seeds, dev)
    opt_hp = {k: torch.as_tensor(np.asarray([o[k] for o in opts]), device=dev)
              for k in ("optimizer", "lr", "weight_decay")}
    return params, opt_hp


def update_bytes(leaves_p, leaves_g, leaves_m, master: bool) -> int:
    """Bytes one fused update moves: each leaf's source of truth (the
    master, else the params), gradient (if any), m and v read once; its
    params, m and v (and master) written once."""
    total = 0
    for p, g, m in zip(leaves_p, leaves_g, leaves_m):
        n = p.numel()
        total += n * (4 if master else p.element_size())            # read p
        total += 0 if g is None else n * g.element_size()           # read g
        total += 4 * n * m.element_size()                           # m, v
        total += n * (p.element_size() + (4 if master else 0))      # write p
    return total


def case(name, params, opt_hp, dev, gen, reps) -> dict:
    s_dtype, master = TYPES[name]
    state = optim.init_state(params, s_dtype, master, lead=(8,))
    live = params
    if master:
        live = tree_map(lambda a: a.to(torch.bfloat16), params)
    leaves = tree_leaves(live)
    none_leaf = len(leaves) // 2

    def grads():
        return tree_unflatten(live, [
            None if i == none_leaf else
            (torch.randn(p.shape, generator=gen, device=dev) * 1e-2).to(
                p.dtype) for i, p in enumerate(leaves)])

    hp = (opt_hp["optimizer"], opt_hp["lr"].float(),
          opt_hp["weight_decay"].float())
    frozen = torch.arange(8, device=dev) != 3
    equal = unchanged = True
    launches = []
    p_k = p_r = live
    s_k = s_r = state
    for step in range(3):
        g = grads()
        upd = frozen if step == 1 else None
        ins = [t for t in tree_leaves((p_k, g, s_k)) if t is not None]
        copies = [t.clone() for t in ins]
        n0 = counters().get("optim.launches", 0)
        p_k, s_k = optim.apply_update(p_k, g, s_k, *hp, upd)
        launches.append(counters().get("optim.launches", 0) - n0)
        p_r, s_r = optim.apply_update_reference(p_r, g, s_r, *hp, upd)
        equal &= all(torch.equal(a, b) for a, b in
                     zip(tree_leaves((p_k, s_k)), tree_leaves((p_r, s_r))))
        unchanged &= all(torch.equal(a, b) for a, b in zip(ins, copies))
        del ins, copies, p_r, s_r
        p_r, s_r = p_k, s_k   # the next step from the same state

    ms = cuda_ms(lambda: optim.apply_update(p_k, g, s_k, *hp), iters=reps)
    plain_ms = cuda_ms(lambda: optim.apply_update_reference(p_k, g, s_k, *hp),
                       iters=max(3, reps // 4))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            optim.apply_update(p_k, g, s_k, *hp)
        torch.cuda.synchronize()
    # per launch the profiler recorded (it may drop the first of a cycle)
    seen = [e for e in prof.key_averages() if "optim_update_kernel" in e.key]
    kernel_us = sum(e.device_time_total for e in seen)
    launched = sum(e.count for e in seen)
    device_ms = kernel_us / launched / 1e3 if kernel_us > 0 else None
    nbytes = update_bytes(tree_leaves(p_k), tree_leaves(g),
                          tree_leaves(s_k["m"]), master)
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    return {"case": name, "trials": 8, "leaves": len(leaves),
            "elements": sum(p.numel() for p in leaves),
            "equal": bool(equal), "inputs_unchanged": bool(unchanged),
            "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "bytes": nbytes, "bound_ms": bound_ms,
            "roofline_pct": (None if device_ms is None
                             else 100.0 * bound_ms / device_ms)}


def run(dev, seed: int = 0, reps: int = 20, types=tuple(TYPES)) -> list:
    """One :func:`case` a type in ``types``, at the pop8 population."""
    params, opt_hp = pop8(dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [case(name, params, opt_hp, dev, gen, reps) for name in types]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_optim_bench: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi()
    lines = [json.dumps({**c, "card": card})
             for c in run(dev, args.seed, args.reps)]
    for line in lines:
        print(line, flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
