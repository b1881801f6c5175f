"""Command-line interface: ``python -m embracenet_tpu_torch <command>`` (port
of ``embracenet_tpu/__main__.py``: the same subcommands, options and JSON
output, plus ``--device`` wherever a command trains or predicts).

    python -m embracenet_tpu_torch preprocess --task active_P_vs_inactive_P --root data
    python -m embracenet_tpu_torch train --model EmbraceNetMultimodal --cell K562 \\
        --task active_P_vs_inactive_P --bf16
    python -m embracenet_tpu_torch sweep --root data --models FFNN CNN
    python -m embracenet_tpu_torch evaluate --checkpoint models/... --cell K562 \\
        --task active_P_vs_inactive_P
    python -m embracenet_tpu_torch parity --results results_dict.json

``train``, ``sweep`` and ``evaluate`` run on the CUDA card; ``--device cpu``
runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def _train_cfg(args):
    from embracenet_tpu_torch.config import TrainConfig

    return TrainConfig(
        num_epochs=args.epochs, batch_size=args.batch_size,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        auprc_on_probabilities=args.auprc_prob,
        width_buckets=args.width_buckets,
        fused_embrace=args.fused_embrace,
        eval_reshuffle=args.eval_reshuffle)


def _cv_cfg(args):
    from embracenet_tpu_torch.config import CVConfig

    return CVConfig(n_folds=args.folds, n_trials=args.trials,
                    sampler=args.sampler, fuse_folds=args.fuse_folds)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="embracenet_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--root", default="data")
        p.add_argument("--cache-dir", default=".embracenet_cache")
        p.add_argument("--task", required=True)

    def add_device(p):
        p.add_argument("--device", default=None,
                       help="where models train and predict: the CUDA card "
                            "by default; 'cpu' runs on the CPU")

    p = sub.add_parser("preprocess", help="build + cache a task's arrays")
    add_common(p)
    p.add_argument("--verbose", action="store_true")

    def add_train_opts(p):
        p.add_argument("--epochs", type=int, default=100)
        p.add_argument("--batch-size", type=int, default=100)
        p.add_argument("--folds", type=int, default=3)
        p.add_argument("--trials", type=int, default=3)
        p.add_argument("--sampler", default="TPE",
                       choices=["TPE", "BO", "random"])
        p.add_argument("--bf16", action="store_true")
        p.add_argument("--auprc-prob", action="store_true",
                       help="probability-AUPRC instead of the reference's "
                            "argmax quirk")
        p.add_argument("--width-buckets", action="store_true",
                       help="width-sliced sub-population programs (min "
                            "FLOPs; more compiled variants)")
        p.add_argument("--fused-embrace", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="fused docking + embracement CUDA kernel "
                            "(ops/embrace.py); unset or --fused-embrace: on "
                            "for every EmbraceNet fit; --no-fused-embrace "
                            "keeps the unfused path")
        p.add_argument("--fuse-folds", action="store_true", default=None,
                       help="train all CV folds' HPO populations (and all "
                            "retrains) as single fused fits — 2 fits per CV "
                            "instead of 2*folds")
        p.add_argument("--eval-reshuffle", action="store_true",
                       help="strict parity: reshuffle eval batches every "
                            "epoch like the reference's test DataLoader")
        p.add_argument("--results", default="results_dict.json")
        p.add_argument("--storage", default="optuna_tuning.db")
        p.add_argument("--checkpoint-dir", default="models")
        add_device(p)

    p = sub.add_parser("train", help="K-fold CV with HPO for one model/cell")
    add_common(p)
    p.add_argument("--model", required=True)
    p.add_argument("--cell", required=True)
    p.add_argument("--augmentation", action="store_true")
    add_train_opts(p)

    p = sub.add_parser("sweep", help="cells x tasks x models grid")
    p.add_argument("--root", default="data")
    p.add_argument("--cache-dir", default=".embracenet_cache")
    p.add_argument("--cells", nargs="*", default=None)
    p.add_argument("--tasks", nargs="*", default=None)
    p.add_argument("--models", nargs="*", default=None)
    add_train_opts(p)

    p = sub.add_parser("evaluate", help="score a checkpoint on a cell/task")
    add_common(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--cell", required=True)
    add_device(p)

    p = sub.add_parser("parity", help="compare results vs BASELINE.md")
    p.add_argument("--results", default="results_dict.json")
    p.add_argument("--baseline", default="BASELINE.md")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from embracenet_tpu_torch import api

    if args.cmd == "preprocess":
        pipe = api.preprocess(args.task, root=args.root,
                              cache_dir=args.cache_dir, verbose=args.verbose)
        print(json.dumps({c: {"rows": int(len(pipe.labels[c])),
                              "features": int(pipe.features[c].shape[1])}
                          for c in pipe.cells()}, indent=1))
        return 0

    if args.cmd == "train":
        from embracenet_tpu_torch.training.results import ResultsDict

        pipe = api.preprocess(args.task, root=args.root,
                              cache_dir=args.cache_dir)
        results = ResultsDict(args.results)
        scores = api.train(args.model, args.cell, args.task, pipeline=pipe,
                           cv_cfg=_cv_cfg(args), train_cfg=_train_cfg(args),
                           augmentation=args.augmentation or None,
                           results=results, storage=args.storage,
                           checkpoint_dir=args.checkpoint_dir, verbose=True,
                           device=args.device)
        print(json.dumps({"average_CV_AUPRC": scores["average_CV_AUPRC"],
                          "final_test_AUPRC_scores":
                          scores["final_test_AUPRC_scores"]}, indent=1))
        return 0

    if args.cmd == "sweep":
        from embracenet_tpu_torch import TASKS
        from embracenet_tpu_torch import sweep as sweep_mod

        pipes = sweep_mod.preprocess_all(args.root, tasks=args.tasks or TASKS,
                                         cache_dir=args.cache_dir)
        kwargs = {}
        if args.cells:
            kwargs["cells"] = args.cells
        if args.tasks:
            kwargs["tasks"] = args.tasks
        if args.models:
            kwargs["models"] = tuple(args.models)
        sweep_mod.run_sweep(pipes, cv_cfg=_cv_cfg(args),
                            train_cfg=_train_cfg(args),
                            results_path=args.results, storage=args.storage,
                            checkpoint_dir=args.checkpoint_dir,
                            device=args.device, **kwargs)
        print(f"results written to {args.results}")
        return 0

    if args.cmd == "evaluate":
        pipe = api.preprocess(args.task, root=args.root,
                              cache_dir=args.cache_dir)
        ev = api.evaluate(args.checkpoint, pipe.cell_data(args.cell),
                          device=args.device)
        print(json.dumps(ev, indent=1))
        return 0

    if args.cmd == "parity":
        from embracenet_tpu_torch import sweep as sweep_mod
        from embracenet_tpu_torch.training.results import ResultsDict
        from embracenet_tpu_torch.visual.report import format_table

        results = ResultsDict(args.results)
        print(format_table(sweep_mod.parity_report(results, args.baseline)))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
