"""Host time of the port's fold rebalancing at a cell line's size.

    python3 tools/torch_rebalance_time.py [--windows 100000]
        [--features 566] [--prevalence 0.05] [--repeats 3]

Makes ``benchkit.make_data`` windows (seed 0) and times, on the host's
CPU, what ``training.cv.KfoldCV`` does to one fold's training split before
its fits: ``data.sampling.knn_sorted`` over the split's positives (SMOTE's
neighbour search) and the whole ``rebalance_views`` (SMOTE on the
features, reverse strands on the sequences).  The split is the first
two thirds of the windows, as a 3-fold CV trains on.  Prints one JSON line
with the sizes, the best and every wall of ``--repeats`` runs and the
host's CPU count.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from embracenet_tpu_torch.benchkit import make_data  # noqa: E402
from embracenet_tpu_torch.data.sampling import knn_sorted  # noqa: E402
from embracenet_tpu_torch.training.cv import rebalance_views  # noqa: E402


def walls(fn, repeats):
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=100_000)
    ap.add_argument("--features", type=int, default=566)
    ap.add_argument("--prevalence", type=float, default=0.05)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    data = make_data(args.windows, args.features, np.random.default_rng(0),
                     prevalence=args.prevalence)
    split = {k: v[:2 * args.windows // 3] for k, v in data.items()}
    positives = split["ffnn"][split["y"] == 1]
    knn = walls(lambda: knn_sorted(positives, 5), args.repeats)
    views = walls(lambda: rebalance_views(split, ("ffnn", "cnn"), "smote", 0.1),
                  args.repeats)
    out = rebalance_views(split, ("ffnn", "cnn"), "smote", 0.1)
    print(json.dumps({
        "split_windows": len(split["y"]), "features": args.features,
        "positives": len(positives), "after_rebalancing": len(out["y"]),
        "knn_sorted_s": min(knn), "knn_sorted_walls_s": knn,
        "rebalance_views_s": min(views), "rebalance_views_walls_s": views,
        "cpu_count": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
