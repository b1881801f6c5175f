"""The five binary classification tasks (port of
``embracenet_tpu/data/tasks.py``).

Parity with `BIOINF_tesi/data_pipe/dataload.py:113-256`
(``Load_Create_Task.get_task``):

  * ``active_E_vs_inactive_E`` / ``active_P_vs_inactive_P``: pass-through of
    the region family with its 0/1 activity labels.
  * ``active_EP_vs_inactive_rest``: concatenate enhancers + promoters, keep
    activity labels.
  * ``active_E_vs_active_P`` / ``inactive_E_vs_inactive_P``: concatenate,
    assign label 1 to the *minority* family (per cell line, by row count —
    enhancers when #E <= #P else promoters; the reference concatenates
    [E, P] when enhancers are the minority and [P, E] otherwise,
    `dataload.py:178-193`), filter to rows whose *original* activity label
    matches (active==1 / inactive==0), and record ``index_fa`` — the surviving
    row indices into the concatenated [E, P] fasta — per cell line
    (`:196-203`).

Returned per task: a ``TaskData`` whose sequence codes are globally shared
with per-cell ``index_fa`` row selections (the reference's alignment
mechanism, `dataprepare.py:222-228`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from embracenet_tpu_torch import TASKS
from embracenet_tpu_torch.data.io import RegionSet


@dataclasses.dataclass
class TaskData:
    task: str
    features: dict        # cell -> [N_cell, D] float64
    feature_names: dict   # cell -> list[str]
    labels: dict          # cell -> [N_cell] int64
    codes: np.ndarray     # [N_fa, 256] uint8 (possibly family-concatenated)
    index_fa: dict | None  # cell -> row indices into codes, or None

    def sequence_codes(self, cell: str) -> np.ndarray:
        """Codes aligned to this cell's labels (applies index_fa)."""
        if self.index_fa is not None:
            return self.codes[self.index_fa[cell]]
        return self.codes


def _concat_family(e: RegionSet, p: RegionSet, cell: str, active_value: int):
    """Minority-relabel construction for E-vs-P tasks (one cell line).

    Data stays in [E, P] order — the same order as the concatenated fasta —
    and the minority family (by row count) is labelled 1.

    Documented divergence: the reference's promoter-minority branch
    (`dataload.py:186-193`) reorders data to [P, E] while labels and row
    indices stay in [E, P] order, silently misaligning rows with labels.
    That branch is dead with the published data (enhancers 63,285 <
    promoters 99,881 rows, so enhancers are always the minority); we
    implement the aligned semantics for both branches.
    """
    n_e, n_p = e.features[cell].shape[0], p.features[cell].shape[0]
    original = np.concatenate([e.labels[cell], p.labels[cell]])
    data = np.concatenate([e.features[cell], p.features[cell]])
    if n_e <= n_p:  # minority: enhancers
        new_labels = np.concatenate([np.ones(n_e, np.int64),
                                     np.zeros(n_p, np.int64)])
    else:           # minority: promoters
        new_labels = np.concatenate([np.zeros(n_e, np.int64),
                                     np.ones(n_p, np.int64)])
    index = np.flatnonzero(original == active_value)
    return data[index], new_labels[index], index


def get_task(dataset: dict, task: str) -> TaskData:
    """Build one of the five tasks from {"enhancers","promoters"} RegionSets."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}: use one of {TASKS}")
    e: RegionSet = dataset["enhancers"]
    p: RegionSet = dataset["promoters"]

    if task == "active_E_vs_inactive_E":
        return TaskData(task, e.features, e.feature_names, e.labels,
                        e.codes, None)
    if task == "active_P_vs_inactive_P":
        return TaskData(task, p.features, p.feature_names, p.labels,
                        p.codes, None)

    cells = sorted(set(e.features) & set(p.features))
    codes = np.concatenate([e.codes, p.codes])

    if task == "active_EP_vs_inactive_rest":
        features = {c: np.concatenate([e.features[c], p.features[c]])
                    for c in cells}
        labels = {c: np.concatenate([e.labels[c], p.labels[c]])
                  for c in cells}
        names = {c: e.feature_names[c] for c in cells}
        return TaskData(task, features, names, labels, codes, None)

    active_value = 1 if task == "active_E_vs_active_P" else 0
    features, labels, index_fa, names = {}, {}, {}, {}
    for c in cells:
        features[c], labels[c], index_fa[c] = _concat_family(
            e, p, c, active_value)
        names[c] = e.feature_names[c]
    return TaskData(task, features, names, labels, codes, index_fa)
