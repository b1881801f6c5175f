"""The port's K-fold CV against the JAX package's, on the CPU: the split
primitives, rebalancing and augmentation (exact), ``weight_reset``, the
accounting of ``KfoldCV`` (sequential and fold-fused) with ``engine.fit``
and ``weight_reset`` replaced in both packages by the same fakes, and the
``ResultsDict`` files; then real port runs on the CPU: fold-fused CV equal
to sequential CV within rtol 1e-5 / atol 1e-6 (as
``tests/test_fold_fusion.py`` holds the JAX package), and
``embracenet_tpu_torch.train`` end to end with ``predict`` on the fold-best
checkpoint."""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from torch_parity import (fake_fit, fake_reset, plain, same_calls,
                          same_checkpoints, to_numpy)

from embracenet_tpu import runtime as jruntime
from embracenet_tpu.config import CVConfig as JCVConfig
from embracenet_tpu.config import TrainConfig as JTrainConfig
from embracenet_tpu.data import sampling as jsampling
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.training import cv as jcv
from embracenet_tpu.training import engine as jengine
from embracenet_tpu.training.modelspec import get_spec as j_get_spec
from embracenet_tpu.training.results import ResultsDict as JResults
from embracenet_tpu.utils import skcompat as jsk
from embracenet_tpu_torch import api as tapi
from embracenet_tpu_torch.config import CVConfig, MeshConfig, TrainConfig
from embracenet_tpu_torch.data import sampling as tsampling
from embracenet_tpu_torch.hpo import search as tsearch
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.hpo.samplers import ReplaySampler
from embracenet_tpu_torch.training import cv as tcv
from embracenet_tpu_torch.training import engine as tengine
from embracenet_tpu_torch.training.modelspec import get_spec as t_get_spec
from embracenet_tpu_torch.training.results import ResultsDict as TResults
from embracenet_tpu_torch.utils import skcompat as tsk


@pytest.mark.parametrize("n,k,seed", [(10, 3, 0), (97, 3, 789), (260, 5, 1),
                                      (1000, 2, 42)])
def test_splits_match_the_jax_package(n, k, seed):
    got, want = tsk.kfold_split(n, k, seed), jsk.kfold_split(n, k, seed)
    assert len(got) == len(want) == k
    for (gt, ge), (wt, we) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(ge, we)
        a, b = tsk.train_test_split(gt, 1 / k, seed), jsk.train_test_split(wt, 1 / k, seed)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for shuffle in (True, False):
        a = tsk.train_test_split(np.arange(n), 0.25, seed, shuffle=shuffle)
        b = jsk.train_test_split(np.arange(n), 0.25, seed, shuffle=shuffle)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _knn_as_native(x, k):
    """``enc_knn`` of ``embracenet_tpu/runtime/ioaccel.cpp`` transcribed:
    a running top-k per row, insertion after equal distances."""
    x = np.asarray(x, np.float64)
    out = []
    for q in range(len(x)):
        best = []
        for r in range(len(x)):
            if r == q:
                continue
            d = 0.0
            for diff in x[q] - x[r]:      # feature by feature, in order
                d += float(diff) * float(diff)
            if len(best) < k or d < best[-1][0]:
                pos = len(best)
                while pos > 0 and best[pos - 1][0] > d:
                    pos -= 1
                best.insert(pos, (d, r))
                del best[k:]
        out.append([r for _, r in best])
    return np.asarray(out)


def test_knn_order_is_the_native_knn_order(rng):
    x = rng.normal(size=(40, 6))
    x[7] = x[3]                         # exact ties keep row order
    x[21] = x[3]
    got = tsampling.knn_sorted(x, 5)
    np.testing.assert_array_equal(got, _knn_as_native(x, 5))
    if jruntime.available():
        np.testing.assert_array_equal(got, jruntime.knn_native(x, x, 5, True))


@pytest.mark.parametrize("case", ["one_ulp_ties", "far_from_origin", "float32"])
def test_knn_candidates_from_the_product_miss_no_neighbour(rng, case):
    """The matrix product only picks candidates: distances a rounding error
    apart, or large norms around small distances (where the product loses
    most), still come out in the exact sums' order."""
    x = rng.normal(size=(60, 9))
    if case == "one_ulp_ties":
        x[11] = x[4]
        x[12] = x[4]
        x[12, 0] = np.nextafter(x[4, 0], np.inf)
        x[13, :] = x[4]
        x[13, 8] = np.nextafter(x[4, 8], -np.inf)
    elif case == "far_from_origin":
        x = 1e6 + 1e-3 * x
    else:
        x = x.astype(np.float32)
    np.testing.assert_array_equal(tsampling.knn_sorted(x, 5),
                                  _knn_as_native(x, 5))


@pytest.fixture
def jax_knn(monkeypatch):
    """The JAX package's SMOTE takes its neighbours from the native kNN;
    where the native library cannot load, the transcription stands in."""
    if not jruntime.available():
        monkeypatch.setattr(jruntime, "knn_native",
                            lambda ref, q, k, self_exclude: _knn_as_native(ref, k))


def _imbalanced(rng, n=400, d=7, prevalence=0.05):
    y = (rng.random(n) < prevalence).astype(np.int64)
    y[:3] = 1
    x = (rng.normal(size=(n, d)) + np.outer(y, rng.normal(size=d))).astype(np.float32)
    codes = rng.integers(0, 4, size=(n, 64)).astype(np.uint8)
    return {"ffnn": x, "cnn": codes, "y": y}


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("prevalence", [0.05, 0.3])
@pytest.mark.parametrize("how", ["smote", "double", "sequence",
                                 "augment_tabular", "augment_sequence"])
def test_rebalancing_matches_the_jax_package(jax_knn, rng, how, prevalence):
    d = _imbalanced(rng, prevalence=prevalence)
    for mod in (tsampling, jsampling):
        assert mod.get_imbalance(d["y"]) == jsampling.get_imbalance(d["y"])
    if how in ("smote", "double"):
        args = (d["ffnn"], d["y"])
        kw = dict(type_augm_genfeatures=how, random_state=5)
        got = tsampling.data_rebalancing(*args, **kw)
        want = jsampling.data_rebalancing(*args, **kw)
    elif how == "sequence":
        got = tsampling.data_rebalancing(d["cnn"], d["y"], sequence=True)
        want = jsampling.data_rebalancing(d["cnn"], d["y"], sequence=True)
    else:
        view = "cnn" if how == "augment_sequence" else "ffnn"
        got = tsampling.data_augmentation(d[view], d["y"],
                                          sequence=view == "cnn")
        want = jsampling.data_augmentation(d[view], d["y"],
                                           sequence=view == "cnn")
    _same_arrays(got, want)
    if prevalence < 0.1 or how.startswith("augment"):
        assert len(got[1]) > len(d["y"])


@pytest.mark.parametrize("mode", ["smote", "double", "augmentation"])
def test_rebalance_views_matches_the_jax_package(jax_knn, rng, mode):
    d = _imbalanced(rng)
    kw = dict(augmentation=mode == "augmentation")
    type_augm = "smote" if mode == "augmentation" else mode
    got = tcv.rebalance_views(d, ("ffnn", "cnn"), type_augm, 0.1, **kw)
    want = jcv.rebalance_views(d, ("ffnn", "cnn"), type_augm, 0.1, **kw)
    assert sorted(got) == sorted(want) == ["cnn", "ffnn", "y"]
    for k in got:
        _same_arrays([got[k]], [want[k]])
    assert len(got["ffnn"]) == len(got["cnn"]) == len(got["y"]) > len(d["y"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix, tree


@pytest.mark.parametrize("model", ["FFNN", "CNN", "EmbraceNetMultimodal"])
def test_weight_reset_keeps_bn_and_refreshes_the_rest(model):
    flat = tspace.sample_params(model, np.random.default_rng(4))
    hp = jspace.params_to_hp(model, flat)
    jspec = j_get_spec(model, in_features_ffnn=8)
    tspec = t_get_spec(model, in_features_ffnn=8)
    key = jax.random.PRNGKey(1)
    old_p, old_bn = jax.tree.map(np.asarray, jax.jit(jspec.init_traced)(
        key, jspec.fan_ins(hp)))
    want = jax.eval_shape(lambda k: jengine.weight_reset(k, jspec, hp, old_p,
                                                         old_bn), key)
    new_p, new_bn = tengine.weight_reset(7, tspec, hp, old_p, old_bn)
    assert new_bn is old_bn
    want_shapes = dict(_leaves(jax.tree.map(lambda s: tuple(s.shape), want[0])))
    got = dict(_leaves(new_p))
    old = dict(_leaves(old_p))
    assert sorted(got) == sorted(want_shapes) == sorted(old)
    n_bn = 0
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want_shapes[path], path
        if any(part.startswith("bn") for part in path.split("/")):
            assert leaf is old[path], path       # kept bit for bit
            n_bn += 1
        else:
            assert isinstance(leaf, torch.Tensor), path
            assert not np.array_equal(leaf.numpy(), old[path]), path
    assert n_bn == (0 if model == "FFNN" else 8)
    again, _ = tengine.weight_reset(7, tspec, hp, old_p, old_bn)
    for path, leaf in _leaves(again):
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(got[path]))


# ---------------------------------------------------------------------------
# KfoldCV accounting with fake fit and weight_reset in both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def cv_fakes(monkeypatch):
    calls = {"jax": [], "torch": []}
    resets = {"jax": [], "torch": []}
    monkeypatch.setattr(jengine, "fit", fake_fit(calls["jax"]))
    monkeypatch.setattr(tengine, "fit", fake_fit(calls["torch"]))
    monkeypatch.setattr(jengine, "weight_reset", fake_reset(resets["jax"]))
    monkeypatch.setattr(tengine, "weight_reset", fake_reset(resets["torch"]))
    return calls, resets


def _run_both(tmp_path, tag, data, model, cv_kw, t_kw):
    out = {}
    for pkg, mod, cvc, tc in (("jax", jcv, JCVConfig, JTrainConfig),
                              ("torch", tcv, CVConfig, TrainConfig)):
        d = tmp_path / f"{pkg}_{tag}"
        d.mkdir(exist_ok=True)
        out[pkg] = (mod.KfoldCV()(
            data, model, task="t", cell_line="HEPG2", cv_cfg=cvc(**cv_kw),
            train_cfg=tc(**t_kw), study_name="s", storage=str(d / "s.db"),
            checkpoint_dir=str(d), test_model_path=mod.checkpoint_name(
                "HEPG2", model, "t", 0)), str(d))
    return out


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("model", ["FFNN", "EmbraceNetMultimodal"])
def test_kfoldcv_accounting_matches_the_jax_package(
        jax_knn, tmp_path, cv_fakes, rng, model, fuse):
    calls, resets = cv_fakes
    # 360 windows: the reference's reverse-strand assert (ratio 0.1 to two
    # decimals) holds in every fold
    data = _imbalanced(rng, n=360, d=8)
    if model == "FFNN":
        data = {k: data[k] for k in ("ffnn", "y")}
    cv_kw = dict(n_folds=3, n_trials=3, sampler="random", fuse_folds=fuse)
    t_kw = dict(num_epochs=5, batch_size=30)
    out = _run_both(tmp_path, "a", data, model, cv_kw, t_kw)
    same_calls(calls)
    assert len(calls["torch"]) == (2 if fuse else 6)
    assert plain(resets["torch"]) == plain(resets["jax"])
    assert len(resets["torch"]) == 3
    for i in ([1] if fuse else [1, 3, 5]):          # the retrains
        assert plain(to_numpy(calls["torch"][i]["kw"]["init_params"])) == plain(
            to_numpy(calls["jax"][i]["kw"]["init_params"]))
    (sj, dj), (st, dt) = out["jax"], out["torch"]
    assert plain(st) == plain(sj)
    assert st["average_CV_AUPRC"] == round(
        float(np.mean(st["final_test_AUPRC_scores"])), 5)
    names = same_checkpoints(dj, dt)
    assert {"s_fold1_result.npz", "s_fold3_result.npz",
            "HEPG2_" + model + "_t_0_test_.npz"} <= set(names)

    # resume: fold 2 lost its result; folds 1 and 3 come from theirs
    for d in (dj, dt):
        os.remove(os.path.join(d, "s_fold2_result.npz"))
    n_before = len(calls["torch"])
    again = _run_both(tmp_path, "a", data, model, cv_kw, t_kw)
    same_calls(calls)
    assert plain(again["torch"][0]) == plain(again["jax"][0])
    assert again["torch"][0]["final_test_AUPRC_scores"] == \
        st["final_test_AUPRC_scores"]
    # the study of fold 2 is complete: only its retrain runs again
    assert len(calls["torch"]) == n_before + 1


@pytest.mark.parametrize("fuse", [False, True])
def test_a_missing_best_trial_checkpoint_warns_and_retrains_fresh(
        tmp_path, cv_fakes, rng, monkeypatch, fuse):
    calls, resets = cv_fakes
    monkeypatch.setattr(tsearch, "save_checkpoint", lambda *a, **k: None)
    data = {k: v for k, v in _imbalanced(rng, n=120, d=8, prevalence=0.3).items()
            if k != "cnn"}
    with pytest.warns(RuntimeWarning, match="best-trial checkpoint missing"):
        tcv.KfoldCV()(data, "FFNN", cv_cfg=CVConfig(
            n_folds=2, n_trials=2, sampler="random", fuse_folds=fuse),
            train_cfg=TrainConfig(num_epochs=3, batch_size=30),
            study_name="s", storage=str(tmp_path / "s.db"),
            checkpoint_dir=str(tmp_path))
    assert not resets["torch"]
    retrains = calls["torch"][1:] if fuse else calls["torch"][1::2]
    if fuse:
        # fresh inits from the streams a sequential fit would draw
        init = to_numpy(retrains[0]["kw"]["init_params"])
        spec = t_get_spec("FFNN", 8)
        for j, fold in enumerate((1, 2)):
            hp = retrains[0]["hp"][j]
            want, _ = spec.init(torch.Generator().manual_seed(
                int(tengine.seed_streams(789 + 200 + fold, 1)[0][0])), hp)
            for k, v in want.items():
                np.testing.assert_array_equal(init[k][j], v.numpy())
    else:
        assert all(c["kw"]["init_params"] is None for c in retrains)
        assert [c["kw"]["seed"] for c in retrains] == [789 + 201, 789 + 202]


def test_results_dict_files_cross_over(tmp_path):
    scores = {"average_CV_AUPRC": 0.4, "final_test_AUPRC_scores":
              [np.float32(0.3), torch.tensor(0.5)],
              "iteration_n_1": {"AUPRC_test": np.asarray([0.2, 0.3])}}
    t = TResults(str(tmp_path / "t.json"))
    t.update("HEPG2", "task", "FFNN", scores)
    t.set_baseline("HEPG2", "task", 0.1)
    t.set_best_augmentation("HEPG2", "task", "smote")
    t.save()
    j = JResults(str(tmp_path / "t.json"))
    assert j.data == t.data
    assert j.get("HEPG2", "task", "FFNN")["final_test_AUPRC_scores"] == \
        [pytest.approx(0.3), 0.5]
    j.update("K562", "task", "CNN", {"x": np.float64(1.5)})
    j.save(str(tmp_path / "j.json"))
    assert TResults(str(tmp_path / "j.json")).data == j.data
    j.save_pickle(str(tmp_path / "r.pickle"))
    r = TResults.from_reference_pickle(str(tmp_path / "r.pickle"),
                                       str(tmp_path / "r.json"))
    assert r.data == j.data and r.path == str(tmp_path / "r.json")
    with open(tmp_path / "r.pickle", "rb") as fh:
        assert pickle.load(fh) == j.data


# ---------------------------------------------------------------------------
# real port runs on the CPU
# ---------------------------------------------------------------------------

def _tabular(rng, n, d=10, imbalance=0.3):
    y = (rng.random(n) < imbalance).astype(np.int64)
    w = rng.normal(size=d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x += np.outer(y * 2.0 - 1.0, w).astype(np.float32) * 0.6
    return {"ffnn": x, "y": y}


def test_fused_cv_equals_sequential_cv(rng, tmp_path):
    # 301 windows: the folds' plans differ in shape, so the fused fit pads
    # them to one stack that no trial may walk beyond its own plan
    data = _tabular(rng, 301)
    cv_kw = dict(n_folds=3, n_trials=3, sampler="random")
    t_cfg = TrainConfig(num_epochs=3, batch_size=40, epoch_chunk=3, patience=2)
    out = {}
    for name, fuse in (("seq", False), ("fused", True)):
        d = tmp_path / name
        d.mkdir()
        out[name] = tcv.KfoldCV()(
            data, "FFNN", cv_cfg=CVConfig(fuse_folds=fuse, **cv_kw),
            train_cfg=t_cfg, study_name="s", storage=str(d / "study.db"),
            checkpoint_dir=str(d), test_model_path="best_model", device="cpu")
        assert (d / "best_model.npz").exists()
    seq, fus = out["seq"], out["fused"]
    for key in ("final_test_AUPRC_scores", "final_train_AUPRC_scores"):
        np.testing.assert_allclose(fus[key], seq[key], rtol=1e-5, atol=1e-6)
    assert abs(fus["average_CV_AUPRC"] - seq["average_CV_AUPRC"]) < 1e-4
    for fold in (1, 2, 3):
        s, f = seq[f"iteration_n_{fold}"], fus[f"iteration_n_{fold}"]
        for key in ("AUPRC_test", "AUPRC_train", "F1_precision_recall"):
            np.testing.assert_allclose(f[key], s[key], rtol=1e-5, atol=1e-6)
        assert (tmp_path / "fused" / f"s_fold{fold}_result.npz").exists()
    rows = {}
    for name in out:
        from embracenet_tpu_torch.hpo.study import Study

        for fold in (1, 2, 3):
            st = Study(f"s_{fold}", str(tmp_path / name / "study.db"))
            rows[name, fold] = [(t.params, t.state) for t in st.trials]
            st.close()
    for fold in (1, 2, 3):
        assert rows["seq", fold] == rows["fused", fold]


_DRAW = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.0,
         "CNN_n_layers": 1, "CNN_out_channels_l0": 16,
         "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.0,
         "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
         "selection_probabilities_FFNN": 0.5,
         "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}


def test_fused_embracenet_cv_equals_sequential_cv(rng, tmp_path, monkeypatch):
    """EmbraceNetMultimodal: the fused search population's deepest CNN (2
    blocks) is deeper than fold 1's own (1 block), and the fused retrain
    pads the folds' plans, yet every trial draws what it draws in its
    fold's sequential fit.  Small draws (per fold, by the sampler's seed)
    keep the CPU time down."""
    draw = dict(_DRAW, FFNN_dropout_l0=0.3, CNN_dropout_l0=0.2,
                CNN_dropout_l1=0.4, n_post_layers=1, EMBRACENET_n_units_l0=32,
                EMBRACENET_dropout_l0=0.2)
    deep = dict(draw, CNN_n_layers=2, CNN_out_channels_l1=32,
                CNN_kernel_size_l1=5)
    draws = {790: [draw, dict(draw, lr=2e-3)], 791: [deep, draw]}
    monkeypatch.setattr(tsearch, "get_sampler",
                        lambda name, seed: ReplaySampler(draws[seed]))
    n, d = 151, 8
    y = (rng.random(n) < 0.3).astype(np.int64)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, rng.normal(size=d))
         ).astype(np.float32)
    data = {"ffnn": x, "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": y}
    out = {}
    for name, fuse in (("seq", False), ("fused", True)):
        d = tmp_path / name
        d.mkdir()
        out[name] = tcv.KfoldCV()(
            data, "EmbraceNetMultimodal",
            cv_cfg=CVConfig(fuse_folds=fuse, n_folds=2, n_trials=2,
                            sampler="random"),
            train_cfg=TrainConfig(num_epochs=2, batch_size=40, epoch_chunk=2),
            study_name="s", storage=str(d / "study.db"), checkpoint_dir=str(d),
            device="cpu")
    for fold in (1, 2):
        s, f = out["seq"][f"iteration_n_{fold}"], out["fused"][f"iteration_n_{fold}"]
        for key in ("AUPRC_test", "AUPRC_train"):
            np.testing.assert_allclose(f[key], s[key], rtol=1e-5, atol=1e-6)


def test_train_runs_embracenet_cv_end_to_end_on_the_cpu(rng, tmp_path):
    n, d = 160, 8
    y = (rng.random(n) < 0.35).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w)).astype(np.float32)
    data = {"ffnn": x, "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": y}
    results = TResults(str(tmp_path / "results.json"))
    scores = tapi.train(
        "EmbraceNetMultimodal", "K562", "t", data=data,
        cv_cfg=CVConfig(n_folds=2, n_trials=1, sampler=ReplaySampler(
            [_DRAW, dict(_DRAW, lr=2e-3)])),
        train_cfg=TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=40),
        results=results, storage=str(tmp_path / "mm.db"),
        checkpoint_dir=str(tmp_path), device="cpu")
    assert len(scores["final_test_AUPRC_scores"]) == 2
    assert all(np.isfinite(scores["final_test_AUPRC_scores"]))
    saved = TResults(str(tmp_path / "results.json"))
    assert saved.get("K562", "t", "EmbraceNetMultimodal")[
        "average_CV_AUPRC"] == scores["average_CV_AUPRC"]
    assert saved.get("K562", "t")["baseline_AUPRC"] == pytest.approx(
        max(float(y.mean()), 0.1))
    ck = str(tmp_path / tcv.checkpoint_name("K562", "EmbraceNetMultimodal",
                                            "t", 0))
    probs = tapi.predict(ck, data, device="cpu")
    assert probs.shape == (n, 2) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_train_refuses_what_is_not_ported(rng):
    """Every mesh form runs (the multi-device path is ported); what is still
    refused: a mesh wider than its world, a mesh of another type, and a
    ``device`` that contradicts the mesh."""
    from embracenet_tpu_torch.parallel.mesh import make_mesh

    data = _tabular(rng, 60)
    with pytest.raises(ValueError, match="init_distributed"):
        tapi.train("FFNN", "HEPG2", "t", data=data, mesh=MeshConfig(2, 1),
                   device="cpu")
    with pytest.raises(TypeError, match="MeshConfig"):
        tcv.KfoldCV()(data, "FFNN", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        tcv.KfoldCV()(data, "FFNN", mesh=make_mesh(1, 1, device_type="cpu"),
                      device="cuda")
    assert tapi.resolve_mesh("auto", "cpu") is None
    assert tapi.resolve_mesh(MeshConfig(), "cpu") is None


def test_a_spec_that_is_not_vmappable_fits_each_architecture_alone(
        rng, tmp_path, monkeypatch):
    data = _tabular(rng, 120, d=6)
    tr = {k: v[:90] for k, v in data.items()}
    va = {k: v[90:] for k, v in data.items()}
    spec = dataclasses.replace(t_get_spec("FFNN", 6), vmappable=False)
    base = {"n_layers": 1, "n_units_l0": 32, "dropout_l0": 0.0,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    draws = [base, dict(base, n_units_l0=64), dict(base, lr=2e-3)]
    fits = []
    real_fit = tengine.fit

    def counting_fit(spec, hps, *a, **kw):
        fits.append(([int(h["widths"][0]) for h in hps], kw["seed"]))
        return real_fit(spec, hps, *a, **kw)

    monkeypatch.setattr(tengine, "fit", counting_fit)
    res = tsearch.run_search(spec, "FFNN", tr, va, "s",
                             storage=str(tmp_path / "s.db"),
                             sampler=ReplaySampler(draws), n_trials=3,
                             train_cfg=TrainConfig(num_epochs=2, batch_size=30),
                             checkpoint_dir=str(tmp_path), seed=5, device="cpu")
    # one fit per statics signature (width 32 twice, width 64 once)
    assert fits == [([32, 32], 5), ([64], 5 + 7919)]
    assert res.n_complete == 3 and res.best_model is not None
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith(".npz")) == \
        ["s0.npz", "s1.npz", "s2.npz"]
