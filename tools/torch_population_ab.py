"""Training throughput of one checkout's population engine on the CUDA card,
for comparing two commits on one card.

    python3 tools/torch_population_ab.py [--root DIR] [--label NAME]
        [--what population,cv]

Imports ``embracenet_tpu_torch`` from the checkout at ``DIR`` (this one by
default) and times, each the second of two runs (the first builds the
kernels and warms cuDNN and cuBLAS):

* ``population``: ``chip_smoke.py``'s train-phase population, the 8 trials
  ``bench.py`` draws (seeds 0-7), bf16, batch 100, width buckets, one
  ``engine.fit`` for each ``plan_buckets`` group, 1 epoch on
  ``make_data``'s 3,000 train and 1,000 test windows: train windows/s,
  fused-kernel launches, then under ``torch.profiler`` the CUDA kernels a
  train step (every kernel of the run over its train batches) and the
  card's busy share (summed kernel time over the unprofiled run's wall);
* ``cv``: ``chip_smoke.py``'s CV phase, ``embracenet_tpu_torch.train`` of
  EmbraceNetMultimodal on 4,000 windows at 566 features and 5 % positives,
  3 folds x 3 TPE trials, 2 epochs, batch 100, float32, sequential and
  fold-fused: wall and fused-kernel launches of each.

Prints one JSON line per measurement with the card's ``nvidia-smi`` name
and power limit.  To compare two checkouts, run it for each in turns
(parent, change, change, parent) in one call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def population(root: str) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from embracenet_tpu_torch.benchkit import IN_FEATURES, make_data
    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.hpo import space
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.batching import balanced_plan
    from embracenet_tpu_torch.training.bucketing import plan_buckets
    from embracenet_tpu_torch.training.modelspec import get_spec
    from embracenet_tpu_torch.utils.profiling import counters

    data = make_data(4000, IN_FEATURES, np.random.default_rng(0))
    train = {k: v[:3000] for k, v in data.items()}
    test = {k: v[3000:] for k, v in data.items()}
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    flats = [space.sample_params("EmbraceNetMultimodal", np.random.default_rng(i))
             for i in range(8)]
    hps = [space.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    opts = [space.optimizer_hp(f) for f in flats]
    groups = plan_buckets(spec, "EmbraceNetMultimodal", hps,
                          in_features=IN_FEATURES)
    cfg = TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=100,
                      compute_dtype="bfloat16", patience=10_000,
                      width_buckets=True)

    def run():
        for idxs in groups:
            engine.fit(spec, [hps[i] for i in idxs], [opts[i] for i in idxs],
                       train, test, cfg)
        torch.cuda.synchronize()

    run()
    launches0 = counters().get("embrace.launches", 0)
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    launches = counters().get("embrace.launches", 0) - launches0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels, busy_us = 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels += evt.count
            us = getattr(evt, "self_device_time_total", None)
            busy_us += evt.self_cuda_time_total if us is None else us
    steps = len(groups) * balanced_plan(train["y"], 100, seed=123).idx.shape[0]
    return {"groups": groups, "train_windows_per_s": 8 * len(train["y"]) / wall,
            "wall_s": wall, "fused_launches": launches, "train_steps": steps,
            "kernels_per_train_step": kernels / steps,
            "busy_share": busy_us / 1e6 / wall}


def cv(root: str) -> dict:
    import numpy as np

    import embracenet_tpu_torch as et
    from embracenet_tpu_torch.benchkit import IN_FEATURES, make_data
    from embracenet_tpu_torch.config import CVConfig, TrainConfig
    from embracenet_tpu_torch.utils.profiling import counters, reset_counters

    data = make_data(4000, IN_FEATURES, np.random.default_rng(0), prevalence=0.05)
    out = {}
    build = os.path.join(root, "embracenet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    for rep in (0, 1):
        for name, fuse in (("sequential", False), ("fused", True)):
            with tempfile.TemporaryDirectory(dir=build) as d:
                reset_counters()
                t0 = time.perf_counter()
                et.train("EmbraceNetMultimodal", "HEPG2", "active_E_vs_inactive_E",
                         data=data,
                         cv_cfg=CVConfig(n_folds=3, n_trials=3, sampler="TPE",
                                         fuse_folds=fuse),
                         train_cfg=TrainConfig(num_epochs=2, epoch_chunk=2,
                                               batch_size=100),
                         storage=os.path.join(d, "s.db"),
                         checkpoint_dir=os.path.join(d, "models"))
                out[name] = {"wall_s": time.perf_counter() - t0,
                             "launches": counters().get("embrace.launches", 0)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--what", default="population,cv")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_population_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from embracenet_tpu_torch.benchkit import nvidia_smi

    card = nvidia_smi()
    for what in args.what.split(","):
        line = {"label": args.label, what: {"population": population,
                                            "cv": cv}[what](root), "card": card}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
