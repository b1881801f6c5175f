"""The port's ``sweep`` against the JAX package's, on the CPU.

* ``load_baseline_md`` reads the repo's ``BASELINE.md`` as JAX does (35
  rows x 6 columns), and ``parity_report``'s row dicts are the rows of the
  JAX DataFrame, over results files written by either package.
* ``run_sweep``'s accounting under a fake ``engine.fit`` and
  ``weight_reset`` in both packages (``torch_parity``): the results dict,
  the checkpoint files and every fit call are equal, with the FFNN
  smote-vs-double contest (an imbalanced cell line) and without it.
* ``preprocess_all`` over a small raw tree equals JAX's, task by task.
* One real small sweep on ``device="cpu"`` runs end to end.

The window counts of the imbalanced data (180, 1 in 12 positive) let every
split of the 2-fold CV pass the reference's reverse-strand assert (a ratio
of 0.1 to two decimals), which both packages keep.
"""

import json
import os

import numpy as np
import pytest
from torch_parity import fake_fit, fake_reset, plain, same_calls, same_checkpoints

from embracenet_tpu import TASKS
from embracenet_tpu import sweep as jsweep
from embracenet_tpu.config import CVConfig as JCVConfig
from embracenet_tpu.config import TrainConfig as JTrainConfig
from embracenet_tpu.training import engine as jengine
from embracenet_tpu.training.results import ResultsDict as JResults
from embracenet_tpu_torch import sweep as tsweep
from embracenet_tpu_torch.benchkit import write_raw_dataset
from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.hpo.samplers import ReplaySampler
from embracenet_tpu_torch.training import engine as tengine
from embracenet_tpu_torch.training.cv import checkpoint_name
from embracenet_tpu_torch.training.results import ResultsDict as TResults
from embracenet_tpu_torch.visual import report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "BASELINE.md")
CELL, TASK = "K562", "active_P_vs_inactive_P"


def test_load_baseline_md_matches_jax():
    got, want = tsweep.load_baseline_md(BASELINE), jsweep.load_baseline_md(BASELINE)
    assert len(got) == len(want) == 35 * 6
    assert list(got) == list(want)
    assert got == want
    assert got[(CELL, TASK, "FFNN")] == 0.3419


def _results_file(path, writer):
    """A results file in ``writer``'s package: entries with and without an
    average, a missing model and a cell the baseline lacks."""
    res = (JResults if writer == "jax" else TResults)(path)
    res.update(CELL, TASK, "FFNN", {"average_CV_AUPRC": 0.40,
                                    "final_test_AUPRC_scores": [0.4, 0.4]})
    res.update(CELL, TASK, "EmbraceNetMultimodal_augmentation",
               {"average_CV_AUPRC": 0.2})
    res.update("HEPG2", "active_E_vs_inactive_E", "CNN",
               {"final_test_AUPRC_scores": [0.1]})
    res.update("NOPE", TASK, "CNN", {"average_CV_AUPRC": 0.9})
    res.set_baseline(CELL, TASK, 0.125)
    res.save()
    return path


def _same_rows(got, frame):
    want = frame.to_dict("records")
    assert len(got) == len(want) == 35 * 5
    assert list(frame.columns) == list(got[0])
    for g, w in zip(got, want):
        for k, v in w.items():
            if g[k] is None:
                assert v is None or np.isnan(v), (g, w)
            else:
                assert g[k] == v, (k, g, w)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_parity_report_rows_match_jax(tmp_path, writer):
    path = _results_file(str(tmp_path / "r.json"), writer)
    got = tsweep.parity_report(TResults(path), BASELINE)
    _same_rows(got, jsweep.parity_report(JResults(path), BASELINE))
    row = next(r for r in got if (r["cell"], r["task"], r["model"])
               == (CELL, TASK, "FFNN"))
    assert row["ours"] == 0.40 and row["reference"] == 0.3419
    assert row["within_tolerance"] is True
    # a plain dict as well as a ResultsDict, and another tolerance
    with open(path) as fh:
        data = json.load(fh)
    _same_rows(tsweep.parity_report(data, BASELINE, tolerance=0.5),
               jsweep.parity_report(data, BASELINE, tolerance=0.5))


# ---------------------------------------------------------------------------
# run_sweep accounting under fake fits
# ---------------------------------------------------------------------------

@pytest.fixture
def sweep_fakes(monkeypatch):
    calls = {"jax": [], "torch": []}
    resets = {"jax": [], "torch": []}
    for pkg, engine in (("jax", jengine), ("torch", tengine)):
        monkeypatch.setattr(engine, "fit", fake_fit(calls[pkg]))
        monkeypatch.setattr(engine, "weight_reset", fake_reset(resets[pkg]))
    return calls, resets


def _data(rng, n=180, d=6, positives=None):
    """``positives`` windows first, the rest negative (1 in 12 by default:
    pos/neg 0.09, below the contest's 0.1)."""
    y = np.zeros(n, np.int64)
    y[:n // 12 if positives is None else positives] = 1
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, rng.normal(size=d))
         ).astype(np.float32)
    return {"ffnn": x, "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": y}


def _sweep_both(tmp_path, data, models):
    out = {}
    for pkg, mod, cvc, tc in (("jax", jsweep, JCVConfig, JTrainConfig),
                              ("torch", tsweep, CVConfig, TrainConfig)):
        d = tmp_path / pkg
        d.mkdir()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        res = mod.run_sweep(
            data_fn=lambda cell, task: data, cells=[CELL], tasks=[TASK],
            models=models,
            cv_cfg=cvc(n_folds=2, n_trials=2, sampler="random"),
            train_cfg=tc(num_epochs=4, batch_size=30),
            results_path=str(d / "results.json"), storage=str(d / "s.db"),
            checkpoint_dir=str(d / "models"), verbose=False, **kw)
        out[pkg] = (res, str(d))
    return out


@pytest.mark.parametrize("case", ["imbalanced", "balanced"])
def test_run_sweep_accounting_matches_jax(tmp_path, rng, sweep_fakes, case):
    calls, resets = sweep_fakes
    if case == "imbalanced":
        data, models = _data(rng), jsweep.DEFAULT_MODELS
    else:
        data, models = _data(rng, n=120, positives=36), ("FFNN", "CNN")
    assert tsweep.DEFAULT_MODELS == jsweep.DEFAULT_MODELS
    out = _sweep_both(tmp_path, data, models)
    (jres, jdir), (tres, tdir) = out["jax"], out["torch"]
    assert plain(tres.data) == plain(jres.data)
    with open(os.path.join(jdir, "results.json")) as fj, \
            open(os.path.join(tdir, "results.json")) as ft:
        assert json.load(ft) == json.load(fj)
    names = same_checkpoints(os.path.join(jdir, "models"),
                             os.path.join(tdir, "models"))
    same_calls(calls)
    assert plain(resets["torch"]) == plain(resets["jax"])

    node = tres.data[CELL][TASK]
    labels = sorted(k for k in node if k not in ("baseline_AUPRC",
                                                 "best_augmentation"))
    if case == "balanced":
        assert labels == ["CNN", "FFNN"] and "best_augmentation" not in node
        assert len(calls["torch"]) == 2 * 2 * 2        # models x folds x fits
        return
    assert labels == sorted(["FFNN_smote", "FFNN_double", "FFNN", "CNN",
                             "ConcatNetMultimodal", "EmbraceNetMultimodal",
                             "EmbraceNetMultimodal_augmentation"])
    assert node["best_augmentation"] == "double"         # the bug-compat label
    assert node["FFNN"] in (node["FFNN_smote"], node["FFNN_double"])
    assert len(calls["torch"]) == 6 * 2 * 2      # six runs x folds x fits
    # each variant trained under its own study name; the winner's fold
    # results and fold-best model were copied to the canonical names
    for study in ("FFNN_smote", "FFNN_double", "FFNN", "CNN",
                  "EmbraceNetMultimodal_augmentationaugmentation"):
        for fold in (1, 2):
            assert f"{CELL}_{TASK}_{study}_fold{fold}_result.npz" in names
    assert checkpoint_name(CELL, "FFNN", TASK, 0) + ".npz" in names
    assert checkpoint_name(CELL, "EmbraceNetMultimodal_augmentation", TASK, 0,
                           augmentation=True) + ".npz" in names


def test_preprocess_all_matches_jax(tmp_path):
    root = str(tmp_path / "data")
    write_raw_dataset(root, (60, 90), {"HEPG2": 14, "K562": 6}, seed=0,
                      nan_share=0.05)
    got = tsweep.preprocess_all(root, cache_dir=str(tmp_path / "tc"))
    want = jsweep.preprocess_all(root, cache_dir=str(tmp_path / "jc"))
    assert list(got) == list(want) == TASKS
    for task in TASKS:
        assert got[task].cells() == want[task].cells() == ["HEPG2", "K562"]
        for cell in want[task].cells():
            g, w = got[task].cell_data(cell), want[task].cell_data(cell)
            assert got[task].feature_names[cell] == want[task].feature_names[cell]
            np.testing.assert_allclose(g["ffnn"], w["ffnn"], rtol=1e-12,
                                       atol=1e-15)
            np.testing.assert_array_equal(g["cnn"], w["cnn"])
            np.testing.assert_array_equal(g["y"], w["y"])
    assert sorted(os.listdir(tmp_path / "tc")) == sorted(os.listdir(tmp_path / "jc"))


def test_a_small_sweep_runs_end_to_end_on_the_cpu(tmp_path, rng):
    """FFNN (the contest runs) and EmbraceNet, 2 folds x 1 trial x 1
    epoch, narrow draws; then the report over its fold-best checkpoints."""
    ffnn = {"n_layers": 1, "n_units_l0": 32, "dropout_l0": 0.0,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    embrace = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.0,
               "CNN_n_layers": 1, "CNN_out_channels_l0": 16,
               "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.0,
               "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
               "selection_probabilities_FFNN": 0.5,
               "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    draws = [ffnn, dict(ffnn, lr=2e-3)] * 2 + [embrace, dict(embrace, lr=2e-3)]
    data = _data(rng)
    ck = str(tmp_path / "models")
    res = tsweep.run_sweep(
        data_fn=lambda cell, task: data, cells=[CELL], tasks=[TASK],
        models=("FFNN", "EmbraceNetMultimodal"),
        cv_cfg=CVConfig(n_folds=2, n_trials=1, sampler=ReplaySampler(draws)),
        train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=40),
        results_path=str(tmp_path / "r.json"), storage=str(tmp_path / "s.db"),
        checkpoint_dir=ck, verbose=False, device="cpu")
    node = res.data[CELL][TASK]
    assert {"FFNN_smote", "FFNN_double", "FFNN", "EmbraceNetMultimodal",
            "baseline_AUPRC"} <= set(node)
    assert node["best_augmentation"] == "double"
    for name in ("FFNN_smote", "FFNN_double", "EmbraceNetMultimodal"):
        assert len(node[name]["final_test_AUPRC_scores"]) == 2
        assert np.isfinite(node[name]["final_test_AUPRC_scores"]).all()
    assert TResults(str(tmp_path / "r.json")).data == res.data
    pairs = treport.CompareModelsResult(ck, n_folds=1, device="cpu")(
        {CELL: data}, TASK, models=("FFNN", "EmbraceNetMultimodal"))
    (p,) = pairs[CELL][("FFNN", "EmbraceNetMultimodal")]["pvalues"]
    assert 0.0 <= p <= 1.0
    # a sweep over a 1 x 1 mesh (no process group) trains as the meshless
    # one: the same FFNN entries
    from embracenet_tpu_torch.parallel.mesh import make_mesh

    meshed = tsweep.run_sweep(
        data_fn=lambda cell, task: data, cells=[CELL], tasks=[TASK],
        models=("FFNN",),
        cv_cfg=CVConfig(n_folds=2, n_trials=1, sampler=ReplaySampler(draws[:4])),
        train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=40),
        results_path=str(tmp_path / "r2.json"), storage=str(tmp_path / "s2.db"),
        checkpoint_dir=str(tmp_path / "models2"), verbose=False,
        mesh=make_mesh(1, 1, device_type="cpu"), device="cpu")
    for name in ("FFNN_smote", "FFNN_double", "FFNN", "best_augmentation"):
        assert meshed.data[CELL][TASK][name] == node[name]
    assert TResults(str(tmp_path / "r2.json")).data == meshed.data
