"""SQLite-backed study persistence with resume accounting and pruning: the
port's own copy of ``embracenet_tpu/hpo/study.py``.  The table, WAL mode and
busy timeout are the same, so one storage file serves both packages and a
study begun by one resumes in the other.

Replaces optuna's storage layer for this framework's needs:
  * studies and trials persist to a SQLite file (the reference stores in
    ``BIOINF_optuna_tuning.db``, `training_models.py:363-366`);
  * resume accounting: a study asked for ``n_trials`` only runs
    ``n_trials - n_complete`` new ones (`training_models.py:366-374`);
  * pruning: MedianPruner (n_startup_trials=5, optuna default) wrapped in
    PatientPruner(patience=2) (`training_models.py:362`).  Note the reference
    regime (3 trials/study) never reaches the median pruner's startup count,
    so pruning is inert there; in population mode we additionally support
    same-epoch population-median pruning (see search.py).
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import time

PRUNED, COMPLETE, FAIL = "PRUNED", "COMPLETE", "FAIL"


@dataclasses.dataclass
class Trial:
    number: int
    state: str
    value: float | None
    params: dict
    intermediate: dict  # epoch -> value


class MedianPruner:
    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, completed: list[Trial], step: int, value: float) -> bool:
        if len(completed) < self.n_startup_trials or step <= self.n_warmup_steps:
            return False
        at_step = [t.intermediate[step] for t in completed
                   if step in t.intermediate]
        if not at_step:
            return False
        at_step = sorted(at_step)
        median = at_step[len(at_step) // 2] if len(at_step) % 2 \
            else 0.5 * (at_step[len(at_step) // 2 - 1] + at_step[len(at_step) // 2])
        return value < median


class PatientPruner:
    """Postpones the wrapped pruner while the trial is still improving
    within ``patience`` recent steps (optuna PatientPruner semantics)."""

    def __init__(self, wrapped, patience: int = 2, min_delta: float = 0.0):
        self.wrapped = wrapped
        self.patience = patience
        self.min_delta = min_delta

    def should_prune(self, completed, step, value, history: list) -> bool:
        if len(history) <= self.patience:
            return False
        recent = history[-(self.patience + 1):]
        best_before = max(recent[:-1])
        if recent[-1] > best_before + self.min_delta:
            return False
        return self.wrapped.should_prune(completed, step, value)


class Study:
    """Minimal ask/tell study bound to one (study_name, sqlite file)."""

    def __init__(self, study_name: str, storage: str = "optuna_tuning.db",
                 direction: str = "maximize", load_if_exists: bool = True):
        self.study_name = study_name
        self.storage = storage
        self.direction = direction
        # Cross-process hardening: WAL lets concurrent sweep processes read
        # while one writes; the busy timeout makes writers queue instead of
        # raising "database is locked" (reference relies on optuna's
        # sqlalchemy layer for this, `training_models.py:361-374`).
        self._conn = sqlite3.connect(storage, timeout=30.0)
        try:
            self._conn.execute("PRAGMA journal_mode=WAL")
        except sqlite3.OperationalError:
            pass  # e.g. read-only or network filesystems; keep default mode
        self._conn.execute("PRAGMA busy_timeout=30000")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS trials ("
            " study TEXT, number INTEGER, state TEXT, value REAL,"
            " params TEXT, intermediate TEXT, ts REAL,"
            " PRIMARY KEY (study, number))")
        self._conn.commit()
        if not load_if_exists:
            self._conn.execute("DELETE FROM trials WHERE study = ?",
                               (study_name,))
            self._conn.commit()

    @property
    def trials(self) -> list[Trial]:
        rows = self._conn.execute(
            "SELECT number, state, value, params, intermediate FROM trials"
            " WHERE study = ? ORDER BY number", (self.study_name,)).fetchall()
        return [Trial(n, s, v, json.loads(p),
                      {int(k): float(x)
                       for k, x in json.loads(i or "{}").items()})
                for n, s, v, p, i in rows]

    def completed_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.state == COMPLETE]

    def pruned_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.state == PRUNED]

    def next_number(self) -> int:
        row = self._conn.execute(
            "SELECT MAX(number) FROM trials WHERE study = ?",
            (self.study_name,)).fetchone()
        return 0 if row[0] is None else row[0] + 1

    def tell(self, number: int, params: dict, value: float | None,
             state: str = COMPLETE, intermediate: dict | None = None):
        self._conn.execute(
            "INSERT OR REPLACE INTO trials VALUES (?,?,?,?,?,?,?)",
            (self.study_name, number, state, value,
             json.dumps(params, default=float),
             json.dumps({str(k): float(v)
                         for k, v in (intermediate or {}).items()}),
             time.time()))
        self._conn.commit()

    @property
    def best_trial(self) -> Trial:
        done = self.completed_trials()
        if not done:
            raise ValueError(f"study {self.study_name!r} has no completed trials")
        key = (lambda t: t.value) if self.direction == "maximize" \
            else (lambda t: -t.value)
        return max(done, key=key)

    def history(self) -> list:
        """(params, value) pairs for sampler conditioning."""
        return [(t.params, t.value) for t in self.completed_trials()]

    def close(self):
        self._conn.close()


def open_study(study_name: str, storage: str, mesh=None) -> Study:
    """The study a rank of ``mesh`` works on: rank 0's in ``storage``;
    every other rank's in memory, holding rank 0's trials (broadcast), so
    every rank resumes and samples alike and rank 0 alone writes the
    file."""
    from embracenet_tpu_torch.parallel.mesh import broadcast, is_writer

    if mesh is None or mesh.device_mesh is None:
        return Study(study_name, storage)
    writer = is_writer(mesh)
    study = Study(study_name, storage if writer else ":memory:")
    trials = broadcast(mesh, study.trials if writer else None)
    if not writer:
        for t in trials:
            study.tell(t.number, t.params, t.value, t.state, t.intermediate)
    return study
