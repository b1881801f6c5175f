"""Entry points (port of ``preprocess``, ``train``, ``predict`` and
``evaluate`` from ``embracenet_tpu/api.py``).

  >>> import embracenet_tpu_torch as et
  >>> pipe = et.preprocess("active_P_vs_inactive_P", root="data")
  >>> scores = et.train("EmbraceNetMultimodal", "K562",
  ...                   "active_P_vs_inactive_P", pipeline=pipe)
  >>> probs = et.predict("models/K562_EmbraceNetMultimodal_..._test_",
  ...                    pipe.cell_data("K562"))
  >>> metrics = et.evaluate("models/...", pipe.cell_data("K562"))

``preprocess`` runs on the host; the others run on the card unless the
caller passes ``device="cpu"``.  ``train`` takes a mesh (``resolve_mesh``):
every rank of a world of processes calls it alike, and rank 0 writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.data.pipeline import Pipeline
from embracenet_tpu_torch.models.reload import load_model
from embracenet_tpu_torch.parallel.mesh import resolve_mesh
from embracenet_tpu_torch.training.cv import KfoldCV, checkpoint_name
from embracenet_tpu_torch.training.results import ResultsDict, baseline_auprc


def preprocess(task: str, root: str = "data", dataset: dict | None = None,
               cache_dir: str | None = ".embracenet_cache",
               verbose: bool = False, **kwargs) -> Pipeline:
    """Load raw data, build the task, scale/impute/select features; cached
    (the cache file is shared with the JAX package)."""
    return Pipeline(task=task, root=root, dataset=dataset,
                    cache_dir=cache_dir, verbose=verbose, **kwargs)


def train(model: str, cell_line: str, task: str,
          pipeline: Pipeline | None = None, data: dict | None = None,
          cv_cfg: CVConfig = CVConfig(), train_cfg: TrainConfig = TrainConfig(),
          augmentation: bool | None = None,
          results: ResultsDict | None = None,
          storage: str = "optuna_tuning.db",
          checkpoint_dir: str = "models",
          random_state: int = 789, verbose: bool = False,
          mesh=None, model_label: str | None = None, device=None) -> dict:
    """K-fold CV with per-fold HPO for one (model, cell, task); returns the
    reference-shaped scores dict and records it into ``results`` if given.

    ``data``: {"ffnn": [N, D] float, "cnn": [N, 256] uint8 codes, "y"};
    with caller-supplied ``data``, ``cell_line`` and ``task`` are labels
    only.  ``data=None`` takes the cell line from ``pipeline``, or from
    ``preprocess(task)`` when no pipeline is given.

    ``mesh``: a ``parallel.mesh.Mesh``, a ``MeshConfig``, ``"auto"`` or None
    (:func:`resolve_mesh`); rank 0 alone writes ``results``.

    ``model_label``: the name that studies, checkpoints and the results
    entry are recorded under, when it is not ``model`` (two runs of one
    family, e.g. with another rebalancer, then keep their files apart).

    Every fit runs on the card unless ``device`` says otherwise
    (``"cpu"``)."""
    mesh = resolve_mesh(mesh, device)
    if data is None:
        from embracenet_tpu_torch import CELL_LINES, TASKS

        if cell_line not in CELL_LINES:
            raise ValueError(f"unknown cell line {cell_line!r}; "
                             f"expected one of {CELL_LINES}")
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
        if pipeline is None:
            pipeline = preprocess(task)
        data = pipeline.cell_data(cell_line)
    if augmentation is not None:
        cv_cfg = dataclasses.replace(cv_cfg, augmentation=augmentation)
    label = model_label or model
    cv = KfoldCV()
    scores = cv(data, model, task=task, cell_line=cell_line,
                cv_cfg=cv_cfg, train_cfg=train_cfg,
                study_name=f"{cell_line}_{task}_{label}"
                           f"{'augmentation' if cv_cfg.augmentation else ''}",
                storage=storage, checkpoint_dir=checkpoint_dir,
                test_model_path=checkpoint_name(
                    cell_line, label, task, 0, cv_cfg.augmentation),
                random_state=random_state, verbose=verbose, mesh=mesh,
                device=device)
    if results is not None:
        # record under the label: a variant run (model_label="FFNN_smote")
        # must not overwrite the canonical family entry — the canonical one
        # is written by visual.report.select_augmented_models after the
        # variant contest (sweep.run_sweep)
        name = label + ("_augmentation" if cv_cfg.augmentation else "")
        results.update(cell_line, task, name, scores)
        results.set_baseline(cell_line, task, baseline_auprc(data["y"]))
        results.save(mesh=mesh)
    return scores


def predict(checkpoint_path: str, data: dict,
            in_features_ffnn: int | None = None, device=None,
            fused_embrace: bool = True) -> np.ndarray:
    """Class probabilities [N, 2] from a saved checkpoint (the reference's
    ``*_NoTrain`` reload flow, softmax output)."""
    return load_model(checkpoint_path, in_features_ffnn, device=device,
                      fused_embrace=fused_embrace)(data)


def evaluate(checkpoint_path: str, data: dict,
             in_features_ffnn: int | None = None,
             auprc_on_probabilities: bool = False, device=None,
             fused_embrace: bool = True) -> dict:
    """AUPRC / AUROC / F1 / precision / recall / accuracy of a checkpoint."""
    from embracenet_tpu_torch.ops import metrics as M

    probs = predict(checkpoint_path, data, in_features_ffnn, device=device,
                    fused_embrace=fused_embrace)
    y = torch.as_tensor(np.asarray(data["y"]))
    probs_t = torch.from_numpy(probs)
    logits = torch.log(torch.clamp(probs_t, min=1e-30))
    if auprc_on_probabilities:
        auprc = float(M.auprc_prob(probs_t[:, 1], y))
    else:
        auprc = float(M.auprc_argmax(logits, y))
    prf = M.f1_precision_recall(logits, y)
    return {
        "AUPRC": auprc,
        "AUROC": float(M.auroc(probs_t[:, 1], y)),
        "precision": float(prf[0]),
        "recall": float(prf[1]),
        "F1": float(prf[2]),
        "accuracy": float(M.accuracy(logits, y)),
        "baseline_AUPRC": baseline_auprc(np.asarray(data["y"])),
    }
