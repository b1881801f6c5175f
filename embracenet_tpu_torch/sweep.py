"""The full sweep (port of ``embracenet_tpu/sweep.py``): the replacement
for the reference's 16 notebooks.

The reference's experiment surface (SURVEY.md §2.5):
  * ``Data_preprocessing.ipynb``  -> :func:`preprocess_all`
  * ``0X_Thesis_BIOINF_<CELL>``   -> unimodal FFNN (smote + double on
    imbalanced tasks, winner selection) and CNN over the 5 tasks
  * ``0X.._Embracenet``           -> EmbraceNetMultimodal (plain +
    augmentation) and ConcatNetMultimodal over the 5 tasks
  * ``Results_Visualisation``     -> visual/report.py

:func:`run_sweep` executes any subset of that grid on the card (or on
``device="cpu"``), accumulates the ``results_dict`` artifact (the JSON
file both packages read) and can be compared against the reference's
published numbers (BASELINE.md) with :func:`parity_report`.
"""

from __future__ import annotations

import dataclasses
import re
import time

from embracenet_tpu_torch import CELL_LINES, TASKS, api
from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.data.sampling import get_imbalance
from embracenet_tpu_torch.parallel.mesh import broadcast
from embracenet_tpu_torch.training.results import ResultsDict, baseline_auprc
from embracenet_tpu_torch.visual.report import (DEFAULT_MODELS,
                                                select_augmented_models)


def preprocess_all(root: str = "data", tasks=TASKS,
                   cache_dir: str = ".embracenet_cache",
                   verbose: bool = False) -> dict:
    """Data_preprocessing equivalent: every task preprocessed + cached."""
    return {task: api.preprocess(task, root=root, cache_dir=cache_dir,
                                 verbose=verbose)
            for task in tasks}


def run_sweep(pipelines: dict | None = None,
              data_fn=None,
              cells=CELL_LINES,
              tasks=TASKS,
              models=DEFAULT_MODELS,
              cv_cfg: CVConfig = CVConfig(),
              train_cfg: TrainConfig = TrainConfig(),
              results_path: str = "results_dict.json",
              storage: str = "optuna_tuning.db",
              checkpoint_dir: str = "models",
              ffnn_both_rebalancers: bool = True,
              rebalance_threshold: float = 0.1,
              verbose: bool = True,
              mesh=None, device=None) -> ResultsDict:
    """Train the cells x tasks x models grid with per-fold HPO.

    ``pipelines``: {task: Pipeline} from :func:`preprocess_all`; or supply
    ``data_fn(cell, task) -> data dict`` for synthetic/preloaded data.

    ``mesh``: a ``parallel.mesh.Mesh``, a ``MeshConfig``, ``"auto"`` or None
    (:func:`api.resolve_mesh`): every rank of the world runs the sweep
    alike, sharding each CV over the mesh, and rank 0 alone writes results,
    studies and checkpoints.  Every fit runs on the card unless ``device``
    says otherwise (``"cpu"``).

    Mirrors the notebook policy: on tasks where the cell line is imbalanced
    (pos/neg < threshold) the FFNN is trained with both rebalancers (smote +
    double) and the winner is selected by Wilcoxon rank-sum
    (`models/utils/utils.py:302-353`); EmbraceNet additionally runs the
    ``augmentation=True`` variant when ``models`` names it.
    """
    mesh = api.resolve_mesh(mesh, device)
    results = ResultsDict(results_path)
    results.data = broadcast(mesh, results.data)    # rank 0's file
    t_start = time.time()
    for cell in cells:
        for task in tasks:
            if data_fn is not None:
                data = data_fn(cell, task)
            else:
                data = pipelines[task].cell_data(cell)
            results.set_baseline(cell, task, baseline_auprc(data["y"]))
            imbalanced = get_imbalance(data["y"]) < rebalance_threshold

            for model in models:
                augmentation = model.endswith("_augmentation")
                family = model.replace("_augmentation", "")
                variants = [(model, cv_cfg.type_augm_genfeatures)]
                if (family == "FFNN" and imbalanced
                        and ffnn_both_rebalancers and not augmentation):
                    variants = [("FFNN_smote", "smote"),
                                ("FFNN_double", "double")]
                for name, rebalancer in variants:
                    if verbose:
                        print(f"=== {cell} / {task} / {name} "
                              f"({time.time() - t_start:.0f}s elapsed)")
                    cfg = dataclasses.replace(
                        cv_cfg, augmentation=augmentation,
                        type_augm_genfeatures=rebalancer)
                    scores = api.train(
                        family, cell, task, data=data, cv_cfg=cfg,
                        train_cfg=train_cfg, results=None, storage=storage,
                        checkpoint_dir=checkpoint_dir, verbose=False,
                        mesh=mesh,
                        model_label=name if name != family else None,
                        device=device)
                    results.update(cell, task, name, scores)
                    results.save(mesh=mesh)
                if len(variants) == 2:
                    try:
                        # Mutates results.data in place: copies the winner
                        # entry to the "FFNN" key and sets the bug-compat
                        # best_augmentation label (utils.py:302-353).
                        select_augmented_models(
                            results.data, cell, task,
                            checkpoint_dir=checkpoint_dir,
                            n_folds=cv_cfg.n_folds, mesh=mesh)
                        results.save(mesh=mesh)
                    except ValueError:
                        pass
    return results


_BASELINE_TASKS = {"T1": "active_E_vs_inactive_E",
                   "T2": "active_P_vs_inactive_P",
                   "T3": "active_E_vs_active_P",
                   "T4": "inactive_E_vs_inactive_P",
                   "T5": "active_EP_vs_inactive_rest"}
_BASELINE_COLS = ("baseline", "FFNN", "CNN", "ConcatNet", "EmbraceNet",
                  "EmbraceNet_augm")
_MODEL_FOR_COL = {"FFNN": "FFNN", "CNN": "CNN",
                  "ConcatNet": "ConcatNetMultimodal",
                  "EmbraceNet": "EmbraceNetMultimodal",
                  "EmbraceNet_augm": "EmbraceNetMultimodal_augmentation"}


def load_baseline_md(path: str = "BASELINE.md") -> dict:
    """Parse the reference's published average_CV_AUPRC table.

    -> {(cell, task, column): value}."""
    out = {}
    row_re = re.compile(r"^\|\s*(\w+)\s*\|\s*(T\d)\s*\|" + r"\s*([\d.]+)\s*\|" * 6)
    with open(path) as fh:
        for line in fh:
            m = row_re.match(line.strip())
            if m:
                cell, t = m.group(1), m.group(2)
                vals = [float(m.group(3 + i)) for i in range(6)]
                for col, v in zip(_BASELINE_COLS, vals):
                    out[(cell, _BASELINE_TASKS[t], col)] = v
    return out


def parity_report(results: ResultsDict | dict,
                  baseline_path: str = "BASELINE.md",
                  tolerance: float = 0.05) -> list:
    """Compare achieved average_CV_AUPRC against the reference's table.

    Returns one row dict per (cell, task, model) with
    ours / reference / delta / within_tolerance: the rows the JAX
    package's DataFrame holds (``visual.report.format_table`` prints
    them).  Tolerance default = the reference's own fold-to-fold std
    (BASELINE.md notes).
    """
    data = results.data if isinstance(results, ResultsDict) else results
    ref = load_baseline_md(baseline_path)
    rows = []
    for (cell, task, col), theirs in ref.items():
        if col == "baseline":
            continue
        model = _MODEL_FOR_COL[col]
        entry = data.get(cell, {}).get(task, {}).get(model)
        ours = entry.get("average_CV_AUPRC") if entry else None
        rows.append({
            "cell": cell, "task": task, "model": col,
            "ours": ours, "reference": theirs,
            "delta": (ours - theirs) if ours is not None else None,
            "within_tolerance": (ours is not None
                                 and ours >= theirs - tolerance),
        })
    return rows
