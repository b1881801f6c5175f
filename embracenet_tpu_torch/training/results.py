"""Results aggregation: the ``results_dict`` artifact (port of
``embracenet_tpu/training/results.py``).

Structure parity with the reference's ``results_dict.pickle`` (SURVEY.md §2.6):
``{cell: {task: {model: {average_CV_AUPRC, final_test_AUPRC_scores[k],
final_train_AUPRC_scores[k], iteration_n_{i}: {AUPRC_train[], AUPRC_test[],
F1_precision_recall[]}}, baseline_AUPRC, best_augmentation}}}``.
Persisted as JSON (and optionally pickle for drop-in compatibility) in the
same format as the JAX package, so either package reads what the other
wrote.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch


def baseline_auprc(y, floor: float = 0.1) -> float:
    """Positive prevalence floored at 0.1 (`visual/visual.py:81-96`)."""
    y = np.asarray(y)
    return float(max(float((y == 1).mean()), floor))


class ResultsDict:
    def __init__(self, path: str = "results_dict.json"):
        self.path = path
        self.data: dict = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                self.data = json.load(fh)

    def update(self, cell_line: str, task: str, model: str, scores: dict):
        cell = self.data.setdefault(cell_line, {})
        cell.setdefault(task, {})[model] = _jsonable(scores)

    def set_baseline(self, cell_line: str, task: str, value: float):
        self.data.setdefault(cell_line, {}).setdefault(task, {})[
            "baseline_AUPRC"] = float(value)

    def set_best_augmentation(self, cell_line: str, task: str, which: str):
        """`select_augmented_models` outcome slot (utils.py:302-353)."""
        self.data.setdefault(cell_line, {}).setdefault(task, {})[
            "best_augmentation"] = which

    def get(self, cell_line: str, task: str, model: str | None = None):
        node = self.data.get(cell_line, {}).get(task, {})
        return node if model is None else node.get(model)

    def save(self, path: str | None = None, mesh=None):
        """Write the JSON; under a ``mesh`` rank 0 alone writes, and every
        rank waits until it has."""
        from embracenet_tpu_torch.parallel.mesh import barrier, is_writer

        if is_writer(mesh):
            with open(path or self.path, "w") as fh:
                json.dump(self.data, fh, indent=1, default=float)
        barrier(mesh)

    def save_pickle(self, path: str):
        """Reference-compatible pickle artifact."""
        with open(path, "wb") as fh:
            pickle.dump(self.data, fh)

    @classmethod
    def from_reference_pickle(cls, pickle_path: str,
                              json_path: str | None = None) -> "ResultsDict":
        """Import a reference ``results_dict.pickle`` (migration helper).

        The reference structure (SURVEY.md §2.6) is nested plain dicts of
        floats/lists, so unpickling yields JSON-able data directly.
        """
        with open(pickle_path, "rb") as fh:
            data = pickle.load(fh)
        out = cls(json_path or "")
        out.data = _jsonable(data)
        if json_path:
            out.path = json_path
        return out


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
