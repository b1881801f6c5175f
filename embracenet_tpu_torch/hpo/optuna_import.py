"""Read-only importer for reference Optuna SQLite storages: the port's own
copy of ``embracenet_tpu/hpo/optuna_import.py``.

The reference persists every HPO study in ``BIOINF_optuna_tuning.db``
(``training_models.py:363-366``, ``training_models_multimodal.py:275``;
126 studies / 387 trials, study naming
``{cell}_{task}_{model}_{fold}[augmentation]``).  This repo's own
:class:`embracenet_tpu_torch.hpo.study.Study` uses a simpler schema (documented
divergence), so the reference DB is imported rather than opened natively:
``load_optuna_db`` maps optuna's RDB tables (``studies``, ``trials``,
``trial_params``, ``trial_values``, ``trial_intermediate_values``) into the
same :class:`~embracenet_tpu_torch.hpo.study.Trial` records the rest of the HPO
stack consumes.  Everything is read-only — the connection is opened with
``mode=ro`` and nothing is written back.

Value decoding follows optuna's RDB internal representation:
``trial_params.param_value`` stores the **index into ``choices``** for
``CategoricalDistribution`` and the raw numeric value for
``Int/(Log)Uniform`` distributions (the ``distribution_json`` column says
which).  Ints round-trip through ``int()`` so ``n_layers`` etc. come back
as Python ints, matching :func:`embracenet_tpu_torch.hpo.space.sample_params`.

This makes the reference DB a *parity oracle*: ``param_census`` collapses
all imported trials into per-model param-name -> observed-values sets that
tests compare against :func:`embracenet_tpu_torch.hpo.space.model_space`
(tests/test_optuna_import.py, tests/test_torch_hpo.py).
"""

from __future__ import annotations

import dataclasses
import json
import re
import sqlite3

from embracenet_tpu_torch.hpo.study import Trial

#: study naming protocol, ``training_models.py:357-363``:
#: ``{cell}_{task}_{model}_{fold}`` with an optional ``augmentation``
#: marker; the real DB carries BOTH historical spellings —
#: ``..._{fold}augmentation`` (glued to the fold, 23 studies) and
#: ``..._augmentation_{fold}`` (3 MCF7 studies).
_STUDY_NAME_RE = re.compile(
    r"^(?P<cell>[A-Z0-9]+)_(?P<task>.+?)_(?P<model>FFNN|CNN_LSTM|CNN|"
    r"EmbraceNetMultimodal|ConcatNetMultimodal)"
    r"(?:_(?P<augm_pre>augmentation))?"
    r"_(?P<fold>\d+)(?P<augm_post>augmentation)?$")


@dataclasses.dataclass(frozen=True)
class ImportedStudy:
    study_name: str
    cell_line: str | None
    task: str | None
    model: str | None
    fold: int | None
    augmentation: bool
    trials: list  # list[Trial]
    direction: str = "MAXIMIZE"  # from optuna's study_directions table

    @property
    def best_trial(self) -> Trial | None:
        done = [t for t in self.trials
                if t.state == "COMPLETE" and t.value is not None]
        if not done:
            return None
        pick = min if self.direction.upper().startswith("MIN") else max
        return pick(done, key=lambda t: t.value)


def _decode_param(value: float, distribution_json: str):
    dist = json.loads(distribution_json)
    name = dist.get("name", "")
    attrs = dist.get("attributes", {})
    if "Categorical" in name:
        return attrs["choices"][int(value)]
    if "Int" in name:
        return int(value)
    return float(value)


def parse_study_name(study_name: str) -> dict:
    """Split a reference study name into its protocol fields (best effort:
    unparseable names get ``None`` fields rather than raising)."""
    m = _STUDY_NAME_RE.match(study_name)
    if not m:
        return {"cell_line": None, "task": None, "model": None,
                "fold": None, "augmentation": False}
    return {"cell_line": m["cell"], "task": m["task"], "model": m["model"],
            "fold": int(m["fold"]),
            "augmentation": bool(m["augm_pre"] or m["augm_post"])}


def load_optuna_db(path: str) -> dict[str, ImportedStudy]:
    """Import every study from an optuna SQLite storage, read-only.

    Returns ``{study_name: ImportedStudy}``; each trial carries its decoded
    params, final objective value, state, and intermediate values keyed by
    report step (the reference reports test-AUPRC per epoch,
    ``training_models.py:336-339``).
    """
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        cur = con.cursor()
        studies = dict(cur.execute(
            "SELECT study_id, study_name FROM studies"))
        directions = dict(cur.execute(
            "SELECT study_id, direction FROM study_directions "
            "WHERE objective=0"))
        params: dict[int, dict] = {}
        for trial_id, pname, pval, dist in cur.execute(
                "SELECT trial_id, param_name, param_value, "
                "distribution_json FROM trial_params"):
            params.setdefault(trial_id, {})[pname] = _decode_param(pval, dist)
        values = dict(cur.execute(
            "SELECT trial_id, value FROM trial_values WHERE objective=0"))
        inter: dict[int, dict] = {}
        for trial_id, step, val in cur.execute(
                "SELECT trial_id, step, intermediate_value "
                "FROM trial_intermediate_values"):
            inter.setdefault(trial_id, {})[int(step)] = float(val)
        by_study: dict[int, list[Trial]] = {}
        for trial_id, number, study_id, state in cur.execute(
                "SELECT trial_id, number, study_id, state FROM trials "
                "ORDER BY study_id, number"):
            v = values.get(trial_id)
            by_study.setdefault(study_id, []).append(Trial(
                number=int(number), state=str(state),
                value=None if v is None else float(v),
                params=params.get(trial_id, {}),
                intermediate=inter.get(trial_id, {})))
    finally:
        con.close()

    out = {}
    for study_id, name in studies.items():
        fields = parse_study_name(name)
        out[name] = ImportedStudy(
            study_name=name, trials=by_study.get(study_id, []),
            direction=str(directions.get(study_id, "MAXIMIZE")), **fields)
    return out


def param_census(studies: dict[str, ImportedStudy]) -> dict[str, dict]:
    """Per-model-family census: ``{model: {param_name: set(observed)}}``.

    Used as a parity test against ``hpo.space.model_space`` — every param
    name the reference's real HPO runs ever sampled must exist in this
    repo's declared space, and every observed categorical value must be in
    the declared menu.
    """
    census: dict[str, dict] = {}
    for st in studies.values():
        if st.model is None:
            continue
        slot = census.setdefault(st.model, {})
        for t in st.trials:
            for pname, pval in t.params.items():
                slot.setdefault(pname, set()).add(pval)
    return census
