"""Preprocessing pipeline facade with on-disk array caching (port of
``embracenet_tpu/data/pipeline.py``).

Equivalent of ``Build_DataLoader_Pipeline``
(`BIOINF_tesi/data_pipe/dataprepare.py:459-595`), which runs
scale -> impute -> label-relevance filter -> redundancy filter once per task
and pickles the whole ``Data_Prepare`` object
(``data_prepare_class_{task}``, `:529-542`).  Here the cached artifact is a
plain ``.npz`` of selected feature arrays + DNA codes per cell line — no
pickled code objects, safely shareable.  The file's format is the JAX
package's, so a cache written by either package loads in the other.

The reference fits scalers on the full matrix before any split (leakage by
design, `dataprepare.py:83-90`); preserved for parity.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from embracenet_tpu_torch import CELL_LINES, TASKS
from embracenet_tpu_torch.data import preprocess
from embracenet_tpu_torch.data.io import load_dataset
from embracenet_tpu_torch.data.tasks import TaskData, get_task


class Pipeline:
    """Preprocessed, task-specific arrays for all cell lines.

    ``walls`` holds the host seconds of each stage of this build: ``load``
    (reading the raw files and building the task), ``scale``, ``impute``
    and ``select`` summed over the cell lines, ``cache`` (writing or
    reading the ``.npz``)."""

    def __init__(self, task: str, root: str | None = "data",
                 dataset: dict | None = None,
                 cache_dir: str | None = ".embracenet_cache",
                 type_test="kruskal_wallis_test", intersection: bool = False,
                 pval_threshold: float = 0.05,
                 spearman_threshold: float = 0.85,
                 impute: bool = True, verbose: bool = False):
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}: use one of {TASKS}")
        self.task = task
        self.cache_path = (os.path.join(cache_dir, f"task_{task}.npz")
                           if cache_dir else None)

        self.walls = dict.fromkeys(("load", "scale", "impute", "select",
                                    "cache"), 0.0)
        clock = time.perf_counter()

        def lap(stage):
            nonlocal clock
            now = time.perf_counter()
            self.walls[stage] += now - clock
            clock = now

        if self.cache_path and os.path.exists(self.cache_path):
            self._load_cache()
            lap("cache")
            return

        if dataset is None:
            dataset = load_dataset(root)
        td: TaskData = get_task(dataset, task)
        lap("load")

        self.features: dict = {}
        self.feature_names: dict = {}
        self.labels: dict = {}
        self.codes: dict = {}
        for cell in td.features:
            x = np.asarray(td.features[cell], np.float64)
            y = np.asarray(td.labels[cell])
            x = preprocess.robust_minmax_scale(x)
            lap("scale")
            if impute and np.isnan(x).any():
                x = preprocess.iterative_impute(x, mean_match_candidates=10)
            lap("impute")
            x_sel, cols = preprocess.select_features(
                x, y, td.feature_names[cell], type_test=type_test,
                intersection=intersection, pval_threshold=pval_threshold,
                spearman_threshold=spearman_threshold, verbose=verbose)
            lap("select")
            self.features[cell] = x_sel.astype(np.float32)
            self.feature_names[cell] = cols
            self.labels[cell] = y.astype(np.int64)
            self.codes[cell] = td.sequence_codes(cell)
            if verbose:
                print(f"{cell}: {x.shape[1]} -> {x_sel.shape[1]} features, "
                      f"{len(y)} rows")
        if self.cache_path:
            self._save_cache()
            lap("cache")

    # -- public ------------------------------------------------------------

    def cells(self):
        return sorted(self.features)

    def cell_data(self, cell_line: str) -> dict:
        """-> {"ffnn": [N, D] f32, "cnn": [N, 256] u8, "y": [N] i64}."""
        if cell_line not in self.features:
            raise ValueError(f"unknown cell line {cell_line!r}: "
                             f"have {self.cells()} (of {CELL_LINES})")
        return {
            "ffnn": self.features[cell_line],
            "cnn": self.codes[cell_line],
            "y": self.labels[cell_line],
        }

    def return_data(self, cell_line: str, hyper_tuning: bool = False,
                    sequence: bool | None = None, random_state: int = 123,
                    test_size: float = 0.25, validation_size: float = 0.15,
                    augmentation: bool = False):
        """Train/test split of one cell line's data (reference
        ``Build_DataLoader_Pipeline.return_data`` / ``Data_Prepare.return_data``,
        `dataprepare.py:320-366, 545-595`).

        Returns (train dict, test dict); with ``hyper_tuning`` the test dict
        is the validation subset (seed+100 split).  ``sequence`` selects a
        single view for API parity; None keeps both views.
        """
        from embracenet_tpu_torch.data.splits import split_data

        data = self.cell_data(cell_line)
        if sequence is True:
            data = {"cnn": data["cnn"], "y": data["y"]}
        elif sequence is False:
            data = {"ffnn": data["ffnn"], "y": data["y"]}
        return split_data(data, hyper_tuning=hyper_tuning,
                          test_size=test_size,
                          validation_size=validation_size,
                          random_state=random_state,
                          augmentation=augmentation)

    # -- cache -------------------------------------------------------------

    def _save_cache(self):
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        flat = {}
        for cell in self.features:
            flat[f"x_{cell}"] = self.features[cell]
            flat[f"y_{cell}"] = self.labels[cell]
            flat[f"codes_{cell}"] = self.codes[cell]
        names = json.dumps(self.feature_names)
        np.savez_compressed(self.cache_path,
                            __names__=np.frombuffer(names.encode(), np.uint8),
                            **flat)

    def _load_cache(self):
        self.features, self.labels, self.codes = {}, {}, {}
        with np.load(self.cache_path) as z:
            self.feature_names = json.loads(bytes(z["__names__"]).decode())
            for k in z.files:
                if k.startswith("x_"):
                    self.features[k[2:]] = z[k]
                elif k.startswith("y_"):
                    self.labels[k[2:]] = z[k]
                elif k.startswith("codes_"):
                    self.codes[k[6:]] = z[k]
