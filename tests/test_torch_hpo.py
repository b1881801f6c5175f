"""The port's HPO stack against the JAX package's, on the CPU: sampler
draws, SQLite study files read by either package, pruner decisions, the
read-only Optuna import, and the accounting of ``run_search`` /
``run_search_fused`` with ``engine.fit`` replaced in both packages by one
deterministic fake (no training, no XLA compile).  Every comparison is
exact: the samplers are numpy code, and the accounting is bookkeeping."""

import dataclasses
import json
import sqlite3

import numpy as np
import pytest
from torch_parity import fake_fit, plain, same_calls, same_checkpoints

from embracenet_tpu.hpo import samplers as jsamp
from embracenet_tpu.hpo import search as jsearch
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.hpo import study as jstudy
from embracenet_tpu.hpo.optuna_import import load_optuna_db as j_load
from embracenet_tpu.hpo.optuna_import import param_census as j_census
from embracenet_tpu.training import engine as jengine
from embracenet_tpu.training.modelspec import get_spec as j_get_spec
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.hpo import samplers as tsamp
from embracenet_tpu_torch.hpo import search as tsearch
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.hpo import study as tstudy
from embracenet_tpu_torch.hpo.optuna_import import load_optuna_db as t_load
from embracenet_tpu_torch.hpo.optuna_import import param_census as t_census
from embracenet_tpu_torch.hpo.optuna_import import parse_study_name
from embracenet_tpu_torch.training import engine as tengine
from embracenet_tpu_torch.training.modelspec import get_spec as t_get_spec

MODELS = ("FFNN", "CNN", "EmbraceNetMultimodal")
IN_FEATURES = 8


def _history(model, n, seed):
    """``n`` completed (params, value) pairs drawn from numpy."""
    rng = np.random.default_rng(100 + seed)
    return [(tspace.sample_params(model, rng), float(rng.random()))
            for _ in range(n)]


def _sampler(pkg, name, seed, history):
    if name == "Replay":
        return pkg.ReplaySampler([p for p, _ in history])
    return pkg.get_sampler(name, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", ["random", "TPE", "BO", "Replay"])
def test_sample_n_draws_as_the_jax_package(name, model, seed):
    hist = _history(model, 15, seed)
    got = tsamp.sample_n(_sampler(tsamp, name, seed, hist), model, 4, hist)
    want = jsamp.sample_n(_sampler(jsamp, name, seed, hist), model, 4, hist)
    assert got == want
    if name in ("TPE", "BO"):
        # 15 observations pass the 10 startup trials: the model-based path
        assert got != tsamp.sample_n(tsamp.RandomSampler(seed), model, 4, hist)


def _fill(study_cls, path, name):
    st = study_cls(name, path)
    rng = np.random.default_rng(3)
    for i in range(5):
        state = jstudy.PRUNED if i == 2 else jstudy.COMPLETE
        value = None if state == jstudy.PRUNED else float(rng.random())
        st.tell(i, tspace.sample_params("FFNN", rng), value, state,
                {e: float(rng.random()) for e in range(1, 4)})
    st.close()


def _trials(study):
    return [dataclasses.asdict(t) for t in study.trials]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_study_resumes_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "study.db")
    first, second = ((jstudy.Study, tstudy.Study) if writer == "jax"
                     else (tstudy.Study, jstudy.Study))
    _fill(first, path, "s")
    a, b = first("s", path), second("s", path)
    assert _trials(a) == _trials(b) and len(_trials(b)) == 5
    assert a.next_number() == b.next_number() == 5
    assert dataclasses.asdict(a.best_trial) == dataclasses.asdict(b.best_trial)
    assert a.history() == b.history()
    b.tell(5, {"lr": 0.1}, 0.99, jstudy.COMPLETE, {1: 0.5})
    assert a.best_trial.number == 5 and a.next_number() == 6
    mode = b._conn.execute("PRAGMA journal_mode").fetchone()[0]
    assert mode == "wal"
    a.close(), b.close()


def _completed(pkg, rng):
    return [pkg.Trial(i, "COMPLETE", float(rng.random()), {},
                      {e: float(rng.random()) for e in range(1, 7)
                       if rng.random() < 0.9})
            for i in range(int(rng.integers(0, 9)))]


@pytest.mark.parametrize("pruner", ["median", "patient"])
def test_pruners_decide_as_the_jax_package(pruner):
    decisions = []
    for k in range(200):
        seed = np.random.default_rng(k)
        comp_t = _completed(tstudy, seed)
        comp_j = [jstudy.Trial(**dataclasses.asdict(t)) for t in comp_t]
        hist = [float(v) for v in seed.random(int(seed.integers(1, 7)))]
        step, value = len(hist), hist[-1]
        if pruner == "median":
            got = tstudy.MedianPruner().should_prune(comp_t, step, value)
            want = jstudy.MedianPruner().should_prune(comp_j, step, value)
        else:
            got = tstudy.PatientPruner(tstudy.MedianPruner(), 2).should_prune(
                comp_t, step, value, hist)
            want = jstudy.PatientPruner(jstudy.MedianPruner(), 2).should_prune(
                comp_j, step, value, hist)
        assert got == want, k
        decisions.append(got)
    assert any(decisions) and not all(decisions)


_OPTUNA_SCHEMA = """
CREATE TABLE studies (study_id INTEGER PRIMARY KEY, study_name TEXT);
CREATE TABLE study_directions (study_direction_id INTEGER PRIMARY KEY,
    direction TEXT, study_id INTEGER, objective INTEGER);
CREATE TABLE trials (trial_id INTEGER PRIMARY KEY, number INTEGER,
    study_id INTEGER, state TEXT, datetime_start TEXT, datetime_complete TEXT);
CREATE TABLE trial_params (param_id INTEGER PRIMARY KEY, trial_id INTEGER,
    param_name TEXT, param_value REAL, distribution_json TEXT);
CREATE TABLE trial_values (trial_value_id INTEGER PRIMARY KEY,
    trial_id INTEGER, objective INTEGER, value REAL, value_type TEXT);
CREATE TABLE trial_intermediate_values (trial_intermediate_value_id INTEGER
    PRIMARY KEY, trial_id INTEGER, step INTEGER, intermediate_value REAL,
    intermediate_value_type TEXT);
"""


def _dist_json(dist):
    if isinstance(dist, tspace.Categorical):
        return {"name": "CategoricalDistribution",
                "attributes": {"choices": list(dist.choices)}}
    if isinstance(dist, tspace.IntUniform):
        return {"name": "IntUniformDistribution",
                "attributes": {"low": dist.low, "high": dist.high}}
    if isinstance(dist, tspace.LogUniform):
        return {"name": "LogUniformDistribution",
                "attributes": {"low": dist.low, "high": dist.high}}
    return {"name": "UniformDistribution",
            "attributes": {"low": dist.low, "high": dist.high}}


def _optuna_db(path):
    """An Optuna-schema storage with reference-style study names: plain,
    ``..._{fold}augmentation``, ``..._augmentation_{fold}``, a minimising
    study and a name outside the protocol."""
    names = ["HEPG2_active_E_vs_inactive_E_FFNN_1",
             "K562_active_P_vs_inactive_P_EmbraceNetMultimodal_2augmentation",
             "MCF7_active_E_vs_active_P_CNN_augmentation_3",
             "A549_inactive_E_vs_inactive_P_CNN_1",
             "scratch_study"]
    rng = np.random.default_rng(7)
    con = sqlite3.connect(path)
    con.executescript(_OPTUNA_SCHEMA)
    trial_id = 0
    for sid, name in enumerate(names, start=1):
        con.execute("INSERT INTO studies VALUES (?, ?)", (sid, name))
        con.execute("INSERT INTO study_directions VALUES (?, ?, ?, 0)",
                    (sid, "MINIMIZE" if sid == 4 else "MAXIMIZE", sid))
        model = parse_study_name(name)["model"] or "FFNN"
        space = tspace.model_space(model)
        for number in range(3):
            trial_id += 1
            state = ("PRUNED", "COMPLETE", "COMPLETE")[number]
            con.execute("INSERT INTO trials VALUES (?, ?, ?, ?, '', '')",
                        (trial_id, number, sid, state))
            for pname, dist in space.items():
                v = dist.sample(rng)
                stored = (dist.choices.index(v)
                          if isinstance(dist, tspace.Categorical) else v)
                con.execute("INSERT INTO trial_params (trial_id, param_name, "
                            "param_value, distribution_json) VALUES (?,?,?,?)",
                            (trial_id, pname, float(stored),
                             json.dumps(_dist_json(dist))))
            if state == "COMPLETE":
                con.execute("INSERT INTO trial_values (trial_id, objective, "
                            "value, value_type) VALUES (?, 0, ?, 'FINITE')",
                            (trial_id, float(rng.random())))
            for step in range(1, 4):
                con.execute("INSERT INTO trial_intermediate_values (trial_id, "
                            "step, intermediate_value, intermediate_value_type)"
                            " VALUES (?, ?, ?, 'FINITE')",
                            (trial_id, step, float(rng.random())))
    con.commit()
    con.close()
    return names


def test_optuna_import_reads_as_the_jax_package(tmp_path):
    path = str(tmp_path / "optuna.db")
    names = _optuna_db(path)
    got, want = t_load(path), j_load(path)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        g, w = got[name], want[name]
        assert (g.cell_line, g.task, g.model, g.fold, g.augmentation,
                g.direction) == (w.cell_line, w.task, w.model, w.fold,
                                 w.augmentation, w.direction)
        assert [dataclasses.asdict(t) for t in g.trials] == \
            [dataclasses.asdict(t) for t in w.trials]
        assert dataclasses.asdict(g.best_trial) == dataclasses.asdict(w.best_trial)
    assert got[names[1]].augmentation and got[names[2]].augmentation
    assert not got[names[0]].augmentation and got[names[4]].model is None
    assert got[names[3]].best_trial.value == min(
        t.value for t in got[names[3]].trials if t.value is not None)
    census = t_census(got)
    assert census == j_census(want)
    for model, slots in census.items():
        space = tspace.model_space(model)
        for pname, seen in slots.items():
            if isinstance(space[pname], tspace.Categorical):
                assert seen <= set(space[pname].choices)


# ---------------------------------------------------------------------------
# run_search / run_search_fused accounting with a fake engine.fit
# ---------------------------------------------------------------------------

@pytest.fixture
def fakes(monkeypatch):
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jengine, "fit", fake_fit(calls["jax"]))
    monkeypatch.setattr(tengine, "fit", fake_fit(calls["torch"]))
    return calls


def _rows(path):
    con = sqlite3.connect(path)
    rows = con.execute("SELECT study, number, state, value, params, "
                       "intermediate FROM trials ORDER BY study, number").fetchall()
    con.close()
    return rows


def _data(rng, n, d=IN_FEATURES):
    return {"ffnn": rng.normal(size=(n, d)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": (rng.random(n) < 0.3).astype(np.int64)}


def _seed_study(pkgs, path, name, n, model):
    """``n`` completed trials with high intermediates, so the reference
    pruner (5 startup trials) is live for the trials that follow."""
    rng = np.random.default_rng(11)
    rows = [(tspace.sample_params(model, rng),
             {e: 0.6 + 0.01 * i for e in range(1, 7)}) for i in range(n)]
    for pkg in pkgs:
        st = pkg.Study(name, path)
        for i, (flat, inter) in enumerate(rows):
            st.tell(i, flat, 0.6 + 0.01 * i, pkg.COMPLETE, inter)
        st.close()


def _same_result(rj, rt):
    assert rt.best_params == rj.best_params
    assert rt.best_value == rj.best_value
    assert (rt.n_complete, rt.n_pruned) == (rj.n_complete, rj.n_pruned)
    assert (rt.best_model is None) == (rj.best_model is None)
    if rj.best_model is not None:
        assert plain(rt.best_model) == plain(rj.best_model)


@pytest.mark.parametrize("width_buckets", [False, True])
@pytest.mark.parametrize("prune", ["reference", "population", "none"])
@pytest.mark.parametrize("model", ["FFNN", "EmbraceNetMultimodal"])
def test_run_search_accounting_matches_the_jax_package(
        tmp_path, fakes, model, prune, width_buckets):
    rng = np.random.default_rng(5)
    tr, va = _data(rng, 90), _data(rng, 40)
    cfg = dict(num_epochs=6, batch_size=20, width_buckets=width_buckets)
    out = {}
    for pkg, search, study, get_spec, cfg_cls in (
            ("jax", jsearch, jstudy, j_get_spec, None),
            ("torch", tsearch, tstudy, t_get_spec, TrainConfig)):
        d = tmp_path / pkg
        d.mkdir()
        db = str(d / "study.db")
        if prune == "reference":
            _seed_study([study], db, "s", 6, model)
        if cfg_cls is None:
            from embracenet_tpu.config import TrainConfig as cfg_cls
        spec = get_spec(model, in_features_ffnn=IN_FEATURES)
        n_trials = 12 if prune == "reference" else 6
        kw = dict(storage=db, sampler="random", n_trials=n_trials,
                  train_cfg=cfg_cls(**cfg), prune=prune,
                  checkpoint_dir=str(d / "ck"), seed=3)
        res = search.run_search(spec, model, tr, va, "s", **kw)
        first_fits = len(fakes[pkg])
        # resume: pruned trials do not count as done, so the reference
        # samples replacements for them; a study without any is complete
        again = search.run_search(spec, model, tr, va, "s", **kw)
        out[pkg] = (res, again, db, str(d / "ck"), first_fits)
    same_calls(fakes)
    rj, aj, dbj, ckj, nj = out["jax"]
    rt, at, dbt, ckt, nt = out["torch"]
    assert nt == nj
    # group gi of a run_search call fits with seed + 7919 * gi
    assert [c["kw"]["seed"] for c in fakes["torch"][:nt]] == \
        [3 + 7919 * gi for gi in range(nt)]
    _same_result(rj, rt)
    _same_result(aj, at)
    if prune == "none":
        assert len(fakes["torch"]) == nt
        _same_result(rt, at)
    rows = _rows(dbt)
    assert rows == _rows(dbj)
    states = {r[2] for r in rows}
    assert states == ({"COMPLETE", "PRUNED"} if prune != "none" else {"COMPLETE"})
    names = same_checkpoints(ckj, ckt)
    assert names == sorted(f"s{r[1]}.npz" for r in rows
                           if r[2] == "COMPLETE" and (prune != "reference" or r[1] >= 6))


@pytest.mark.parametrize("prune", ["reference", "population", "none"])
def test_run_search_fused_accounting_matches_the_jax_package(
        tmp_path, fakes, prune):
    from embracenet_tpu.config import TrainConfig as JTrainConfig

    rng = np.random.default_rng(6)
    folds = [(_data(rng, 80 + 10 * f), _data(rng, 30 + 5 * f))
             for f in range(3)]
    cfg = dict(num_epochs=6, batch_size=20)
    model = "FFNN"
    names = [f"s_{f + 1}" for f in range(3)]
    out = {}
    for pkg, search, study, get_spec, cfg_cls in (
            ("jax", jsearch, jstudy, j_get_spec, JTrainConfig),
            ("torch", tsearch, tstudy, t_get_spec, TrainConfig)):
        d = tmp_path / pkg
        d.mkdir()
        db = str(d / "study.db")
        if prune == "reference":
            for name in names[:2]:
                _seed_study([study], db, name, 6, model)
        spec = get_spec(model, in_features_ffnn=IN_FEATURES)
        kw = dict(storage=db, sampler="random", train_cfg=cfg_cls(**cfg),
                  prune=prune, checkpoint_dir=str(d / "ck"))
        n_trials = 10 if prune == "reference" else 4
        # fold 3 of an earlier run is complete: only folds 1 and 2 fuse
        search.run_search(spec, model, *folds[2], names[2], seed=13,
                          n_trials=n_trials, **dict(kw, prune="none"))
        res = search.run_search_fused(spec, model, folds, names, [11, 12, 13],
                                      n_trials=n_trials, **kw)
        again = search.run_search_fused(spec, model, folds, names,
                                        [11, 12, 13], n_trials=n_trials, **kw)
        out[pkg] = (res, again, db, str(d / "ck"))
    same_calls(fakes)
    fused = fakes["torch"][1]["kw"]           # [0] is fold 3's own search
    want_init, want_run = [], []
    for f in (0, 1):
        i_s, r_s = tengine.seed_streams(11 + f, 4)
        want_init += list(i_s)
        want_run += list(r_s)
    assert list(fused["init_seeds"]) == want_init
    assert list(fused["run_seeds"]) == want_run
    for rj, rt in zip(out["jax"][0] + out["jax"][1],
                      out["torch"][0] + out["torch"][1]):
        _same_result(rj, rt)
    rows = _rows(out["torch"][2])
    assert rows == _rows(out["jax"][2])
    for name in names:
        assert sum(r[0] == name and r[2] == "COMPLETE" for r in rows) >= 4
    assert {r[2] for r in rows} == (
        {"COMPLETE"} if prune == "none" else {"COMPLETE", "PRUNED"})
    same_checkpoints(out["jax"][3], out["torch"][3])


def test_concat_fold_views_matches_the_jax_package(rng):
    datas = [_data(rng, n) for n in (5, 7, 3)]
    got = tsearch.concat_fold_views(datas, ("ffnn", "cnn", "y"))
    want = jsearch.concat_fold_views(datas, ("ffnn", "cnn", "y"))
    assert got[1] == want[1] == [0, 5, 12]
    assert plain(got[0]) == plain(want[0])


def test_run_search_fused_refuses_a_spec_that_is_not_vmappable():
    spec = dataclasses.replace(t_get_spec("FFNN", IN_FEATURES), vmappable=False)
    with pytest.raises(ValueError, match="vmappable"):
        tsearch.run_search_fused(spec, "FFNN", [], [], [])


def test_samplers_raise_as_the_jax_package():
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamp.get_sampler("grid")
    smp = tsamp.ReplaySampler([{"lr": 0.1}])
    smp.sample({}, [])
    with pytest.raises(ValueError, match="exhausted"):
        smp.sample({}, [])
    assert jspace.model_space("FFNN").keys() == tspace.model_space("FFNN").keys()
