"""The port's ``visual.report`` against the JAX package's, on the CPU.

* Table functions return the nested dicts the JAX functions hand to
  ``pd.DataFrame`` (pandas is not a dependency of the port); here
  ``pd.DataFrame(port_result)`` must equal the JAX DataFrame cell by cell,
  NaN where it has NaN.
* ``compare_model_overall_performance``: p-values within 1e-12.
* ``select_augmented_models``: the same winner, label, results and copied
  files in both branches, with ``fix_label_bug`` off and on.
* ``CompareModelsResult`` over the same checkpoints written by the JAX
  package, the port on ``device="cpu"``: p-values within 1e-9 and the same
  ``different`` flags.  Eval-mode embracement draws from another RNG stream
  in each package (a stated divergence), so EmbraceNet is held only at
  selection probability 0 and 1; FFNN, CNN and ConcatNet at any setting.
* ``save_pval_dict`` pickles load equal; plots render.
"""

import copy
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from torch_parity import IN_FEATURES, flat_embracenet, same_text_table, to_numpy

from embracenet_tpu.models import reload as jreload
from embracenet_tpu.training.checkpoint import save_checkpoint as j_save
from embracenet_tpu.training.cv import checkpoint_name
from embracenet_tpu.visual import report as jreport
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.models import reload as treload
from embracenet_tpu_torch.training.modelspec import get_spec as t_get_spec
from embracenet_tpu_torch.visual import report as treport

TASK = "active_P_vs_inactive_P"
TASKS = [TASK, "active_E_vs_inactive_E"]


def same_frame(got: pd.DataFrame, want: pd.DataFrame):
    """Equal cell by cell, NaN where ``want`` has NaN."""
    assert sorted(map(str, got.columns)) == sorted(map(str, want.columns))
    assert sorted(map(str, got.index)) == sorted(map(str, want.index))
    for col in want.columns:
        for row in want.index:
            a, b = got.loc[row, col], want.loc[row, col]
            if pd.isna(b):
                assert pd.isna(a), (row, col)
            else:
                assert a == b, (row, col, a, b)


@pytest.fixture
def results():
    def entry(avg, scores):
        return {"average_CV_AUPRC": avg, "final_test_AUPRC_scores": scores,
                "final_train_AUPRC_scores": [s + 0.1 for s in scores],
                "iteration_n_1": {"AUPRC_train": [0.2, 0.3],
                                  "AUPRC_test": [0.25, 0.31],
                                  "F1_precision_recall": [[0.5, 0.5, 0.5]] * 2}}

    return {
        "K562": {
            TASK: {"FFNN": entry(0.34, [0.3, 0.35, 0.37]),
                   "CNN": entry(0.24, [0.2, 0.25, 0.27]),
                   "EmbraceNetMultimodal": entry(0.27, [0.25, 0.27, 0.29]),
                   "ConcatNetMultimodal": entry(0.33, [0.3, 0.33, 0.36]),
                   "baseline_AUPRC": 0.125},
            # a task with a missing model, an entry without an average and
            # one without fold scores
            "active_E_vs_inactive_E": {
                "FFNN": {"final_test_AUPRC_scores": [0.1, 0.2]},
                "CNN": entry(0.3, []),
                "EmbraceNetMultimodal": entry(0.41, [0.4, 0.42, 0.41]),
                "EmbraceNetMultimodal_augmentation": entry(0.44, [0.43, 0.45])},
        },
        "HEPG2": {TASK: {"FFNN": entry(0.5, [0.45, 0.55]),
                         "EmbraceNetMultimodal": entry(0.52, [0.5, 0.54])}},
    }


def test_label_tables_match_jax(rng):
    labels = {"t1": {"K562": np.array([1] * 10 + [0] * 90),
                     "H1": (rng.random(77) < 0.31).astype(int)},
              # another cell set: NaN where a task lacks a cell
              "t2": {"K562": (rng.random(123) < 0.07).astype(int),
                     "HEPG2": np.array([1] * 3 + [0] * 997)}}
    for name in ("get_imbalance_ratio_df", "get_baseline_df"):
        got = getattr(treport, name)(labels)
        assert isinstance(got, dict)
        same_frame(pd.DataFrame(got), getattr(jreport, name)(labels))
    assert np.isnan(treport.get_baseline_df(labels)["t2"]["H1"])


@pytest.mark.parametrize("cell", ["K562", "HEPG2", "MCF7"])
@pytest.mark.parametrize("name", ["get_average_auprc_df", "get_standard_dev_df"])
def test_results_tables_match_jax(results, name, cell):
    got = getattr(treport, name)(results, cell, tasks=TASKS)
    same_frame(pd.DataFrame(got), getattr(jreport, name)(results, cell,
                                                         tasks=TASKS))


@pytest.mark.parametrize("cells", [["K562"], ["K562", "HEPG2"], ["MCF7"]])
def test_overall_comparison_matches_jax(results, cells):
    got = treport.compare_model_overall_performance(results, tasks=TASKS,
                                                    cells=cells)
    want = jreport.compare_model_overall_performance(results, tasks=TASKS,
                                                     cells=cells)
    frame = pd.DataFrame(got).T
    assert list(frame.index) == list(want.index)
    for row in want.index:
        assert got[row]["n"] == want.loc[row, "n"]
        for col in ("two_sided_p", "greater_p"):
            a, b = got[row][col], want.loc[row, col]
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12, (row, col)


def test_format_table_prints_what_pandas_prints(results):
    avg = treport.get_average_auprc_df(results, "K562", tasks=TASKS)
    same_text_table(treport.format_table(avg),
                    jreport.get_average_auprc_df(results, "K562",
                                                 tasks=TASKS).to_string())
    rows = [{"cell": "K562", "ours": None, "ok": False},
            {"cell": "H1", "ours": 0.123456789, "ok": True}]
    same_text_table(treport.format_table(rows),
                    pd.DataFrame(rows).to_string(index=False))


# ---------------------------------------------------------------------------
# select_augmented_models
# ---------------------------------------------------------------------------

CONTESTS = {
    # separated folds: rank-sum p < 0.3 and double's average higher
    "double_wins": ([0.2, 0.22, 0.21], [0.4, 0.42, 0.41]),
    # interleaved folds: p >= 0.3, so smote wins though double's mean is higher
    "smote_by_p": ([0.30, 0.34, 0.32], [0.31, 0.33, 0.35]),
    # p < 0.3 but double's average lower
    "smote_by_average": ([0.4, 0.42, 0.41], [0.2, 0.22, 0.21]),
}


def _write_variant_files(d):
    """Both filename protocols for folds 0-3 of both variants (fold 3
    missing for double's resume files)."""
    os.makedirs(d, exist_ok=True)
    for variant in ("FFNN_smote", "FFNN_double"):
        for fold in range(4):
            tree = {"params": {"w": np.full(2, fold, np.float32)}}
            meta = {"model": "FFNN", "variant": variant}
            j_save(os.path.join(d, checkpoint_name("K562", variant, "t", fold)),
                   tree, meta)
            if not (variant == "FFNN_double" and fold == 3):
                j_save(os.path.join(d, f"K562_t_{variant}_fold{fold}_result"),
                       tree, meta)


@pytest.mark.parametrize("fix_label_bug", [False, True])
@pytest.mark.parametrize("contest", sorted(CONTESTS))
def test_select_augmented_models_matches_jax(tmp_path, contest, fix_label_bug):
    smote, double = CONTESTS[contest]

    def entry(scores):
        return {"final_test_AUPRC_scores": list(scores),
                "average_CV_AUPRC": float(np.mean(scores))}

    res = {"K562": {"t": {"FFNN_smote": entry(smote),
                          "FFNN_double": entry(double)}}}
    out = {}
    for name, mod in (("jax", jreport), ("torch", treport)):
        d = str(tmp_path / name)
        _write_variant_files(d)
        r = copy.deepcopy(res)
        winner = mod.select_augmented_models(r, "K562", "t", checkpoint_dir=d,
                                             n_folds=3,
                                             fix_label_bug=fix_label_bug)
        files = {n: open(os.path.join(d, n), "rb").read()
                 for n in sorted(os.listdir(d))}
        out[name] = (winner, r, files)
    assert out["torch"][0] == out["jax"][0] == (
        "double" if contest == "double_wins" else "smote")
    assert out["torch"][1] == out["jax"][1]
    node = out["torch"][1]["K562"]["t"]
    assert node["best_augmentation"] == (out["torch"][0] if fix_label_bug
                                         else "double")
    assert node["FFNN"] == node[f"FFNN_{out['torch'][0]}"]
    assert out["torch"][2] == out["jax"][2]
    assert "K562_FFNN_t_0_test_.npz" in out["torch"][2]
    with pytest.raises(ValueError, match="FFNN_smote and FFNN_double"):
        treport.select_augmented_models({}, "K562", "t", checkpoint_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# CompareModelsResult over checkpoints the JAX package wrote
# ---------------------------------------------------------------------------

N = 150


def _flat(model, p_ffnn=0.5, seed=0):
    if model == "FFNN":
        return {"n_layers": 2, "n_units_l0": 64 - 16 * seed, "n_units_l1": 32}
    if model == "CNN":
        return {"n_layers": 2, "out_channels_l0": 16, "out_channels_l1": 32,
                "kernel_size_l0": 5, "kernel_size_l1": 11}
    flat = flat_embracenet(p_ffnn)
    if model == "ConcatNetMultimodal":
        flat = {k: v for k, v in flat.items()
                if not k.startswith(("EMBRACENET", "n_post", "selection"))}
        flat["CONCATNET_n_post_layers"] = 2
        for i, w in enumerate((64, 32)):
            flat[f"CONCATNET_n_units_l{i}"] = w
            flat[f"CONCATNET_dropout_l{i}"] = 0.0
    return flat


def _jax_checkpoint(d, name, family, fold, flat, seed):
    """A checkpoint written by the JAX package's ``save_checkpoint`` under
    the reference's name for (K562, ``name``, TASK, ``fold``)."""
    hp = tspace.params_to_hp(family, flat)
    params, bn = t_get_spec(family, IN_FEATURES).init(
        torch.Generator().manual_seed(seed), hp)
    j_save(os.path.join(d, checkpoint_name("K562", name, TASK, fold)),
           {"params": to_numpy(params), "bn_state": to_numpy(bn)},
           {"model": family, "model_params": flat})


@pytest.fixture
def small_batches(monkeypatch):
    monkeypatch.setattr(jreload.ReloadedModel, "BATCH", 128)
    monkeypatch.setattr(treload.ReloadedModel, "BATCH", 128)


@pytest.fixture
def data(rng):
    y = (rng.random(N) < 0.3).astype(np.int64)
    x = rng.normal(size=(N, IN_FEATURES)).astype(np.float32)
    x[:, 0] += 1.5 * y
    return {"ffnn": x, "y": y,
            "cnn": rng.integers(0, 4, size=(N, 256)).astype(np.uint8)}


def _both(d, data, models, n_folds):
    want = jreport.CompareModelsResult(d, n_folds=n_folds)({"K562": data}, TASK,
                                                           models=models)
    cmp = treport.CompareModelsResult(d, n_folds=n_folds, device="cpu")
    return cmp, cmp({"K562": data}, TASK, models=models), want


def _same_result(got, want):
    assert list(got) == list(want) == ["K562"]
    assert list(got["K562"]) == list(want["K562"])
    for pair, w in want["K562"].items():
        g = got["K562"][pair]
        assert isinstance(g["different"], bool)
        assert g["different"] == w["different"], pair
        assert len(g["pvalues"]) == len(w["pvalues"])
        for a, b in zip(g["pvalues"], w["pvalues"]):
            assert abs(a - b) <= 1e-9, (pair, a, b)


@pytest.mark.parametrize("p_ffnn", [0.0, 1.0])
def test_compare_models_result_matches_jax(tmp_path, small_batches, data,
                                           p_ffnn):
    models = ("FFNN", "CNN", "ConcatNetMultimodal", "EmbraceNetMultimodal")
    for i, m in enumerate(models):
        _jax_checkpoint(str(tmp_path), m, m, 0, _flat(m, p_ffnn), seed=i)
    cmp, got, want = _both(str(tmp_path), data, models, n_folds=1)
    _same_result(got, want)
    assert len(got["K562"]) == 6
    # the reference-named pickle of both packages loads equal
    jdir, tdir = tmp_path / "jax_pvals", tmp_path / "torch_pvals"
    jdir.mkdir()
    tdir.mkdir()
    jpath = jreport.CompareModelsResult().save_pval_dict(want, TASK, str(jdir))
    tpath = cmp.save_pval_dict(got, TASK, str(tdir))
    assert os.path.basename(tpath) == os.path.basename(jpath) == \
        f"pval_results_dict_{TASK}.pickle"
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        pj, pt = pickle.load(fj), pickle.load(ft)
    assert type(pt) is type(pj) and pt == pj
    assert set(pt[TASK]["K562"]) == {"1"}


def test_compare_models_result_over_folds_matches_jax(tmp_path, small_batches,
                                                      data):
    """Two FFNNs of other widths under two model names, three folds of
    their own weights: per-fold p-values, the majority vote, and the plain
    pickle of ``save``."""
    for name, seed in (("FFNN", 0), ("CNN", 1)):
        for fold in range(3):
            _jax_checkpoint(str(tmp_path), name, "FFNN", fold,
                            _flat("FFNN", seed=seed), seed=10 * seed + fold)
    cmp, got, want = _both(str(tmp_path), data, ("FFNN", "CNN"), n_folds=3)
    _same_result(got, want)
    assert len(got["K562"][("FFNN", "CNN")]["pvalues"]) == 3
    cmp.save(got, str(tmp_path / "pvals.pickle"))
    with open(tmp_path / "pvals.pickle", "rb") as fh:
        assert pickle.load(fh) == got


def test_plots_render(results, tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    treport.plot_scores(results, "K562", TASK, "FFNN",
                        save_path=str(tmp_path / "s.png"))
    treport.plot_label_ratio({"K562": np.array([1, 0, 0, 1]),
                              "H1": np.array([0, 0, 1, 1])}, "t",
                             save_path=str(tmp_path / "p.png"))
    fig = treport.plot_fold_scores(results, ["K562", "HEPG2"],
                                   models=("FFNN", "CNN"),
                                   save_path=str(tmp_path / "cat.png"))
    for name in ("s.png", "p.png", "cat.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"
    assert len(fig.axes) == 2 * 2       # tasks x cells facets
