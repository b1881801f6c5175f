#!/usr/bin/env python
"""Quickstart of the PyTorch port: the reference's notebook workflow in one
script (the port of ``examples/quickstart.py``).

Generates a small dataset in the reference's on-disk layout (or point
``--root`` at real data/enhancers + data/promoters), then runs:
preprocess -> K-fold CV with HPO for FFNN and EmbraceNet -> reports.
Training runs on the CUDA card; ``--device cpu`` runs it on the CPU.

    python examples/torch_quickstart.py --epochs 1 [--device cpu]
"""

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import embracenet_tpu_torch as et  # noqa: E402
from embracenet_tpu_torch.config import CVConfig, TrainConfig  # noqa: E402
from embracenet_tpu_torch.training.results import ResultsDict  # noqa: E402
from embracenet_tpu_torch.visual import report  # noqa: E402


def make_demo_data(root: str, rng):
    """The JAX quickstart's demo tree, drawn from ``rng`` in the same order:
    per family a ``<CELL>.csv`` of 16 features per cell line (20 %
    positives, 5 shifted columns), one ``.bed`` of labels and a
    sequence-first ``.fa`` of 256-bp windows."""
    for family, n in (("enhancers", 300), ("promoters", 600)):
        d = os.path.join(root, family)
        os.makedirs(d, exist_ok=True)
        starts = np.arange(n) * 300
        coords = [["chr1", int(s), int(s) + 256] for s in starts]
        labels = {}
        for cell in et.CELL_LINES:
            y = (rng.random(n) < 0.2).astype(int)
            feats = rng.normal(size=(n, 16))
            feats[:, :5] += np.outer(y, rng.normal(size=5) + 1.5)
            with open(os.path.join(d, f"{cell}.csv"), "w", newline="") as fh:
                w = csv.writer(fh)
                w.writerow(["chrom", "chromStart", "chromEnd", "strand"]
                           + [f"f{j}" for j in range(16)])
                for c, row in zip(coords, feats):
                    w.writerow(c + ["+"] + [repr(float(v)) for v in row])
            labels[cell] = y
        with open(os.path.join(d, f"{family}.bed"), "w", newline="") as fh:
            w = csv.writer(fh, delimiter="\t", lineterminator="\n")
            w.writerow(["chrom", "chromStart", "chromEnd", *labels])
            for i, c in enumerate(coords):
                w.writerow(c + [int(y[i]) for y in labels.values()])
        with open(os.path.join(d, f"{family}.fa"), "w") as fh:
            for i in range(n):
                seq = "".join(rng.choice(list("acgt"), 256))
                fh.write(seq + "\n" + f">chr1:{i*300}-{i*300+256}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="demo_data")
    ap.add_argument("--cell", default="K562")
    ap.add_argument("--task", default="active_P_vs_inactive_P")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    if not os.path.exists(args.root):
        print(f"generating demo data under {args.root}/")
        make_demo_data(args.root, np.random.default_rng(0))

    pipe = et.preprocess(args.task, root=args.root)
    results = ResultsDict("results_dict.json")
    for model in ("FFNN", "EmbraceNetMultimodal"):
        print(f"== training {model} on {args.cell} / {args.task}")
        scores = et.train(
            model, args.cell, args.task, pipeline=pipe,
            cv_cfg=CVConfig(n_folds=3, n_trials=3, sampler="TPE"),
            train_cfg=TrainConfig(num_epochs=args.epochs),
            results=results, verbose=True, device=args.device)
        print(f"   average_CV_AUPRC = {scores['average_CV_AUPRC']}")

    print(report.format_table(report.get_average_auprc_df(
        results.data, args.cell, models=("FFNN", "EmbraceNetMultimodal"),
        tasks=[args.task])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
