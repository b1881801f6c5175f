"""The port's data layer against the JAX package's, on the CPU, from raw
``.csv`` / ``.bed`` / ``.fa`` files written under ``tmp_path`` in the
reference's layout (``benchkit.write_raw_dataset``: missing cells written
empty and ``NA``, sequences with upper-case bases and ``n``).

* Codes and labels are equal bit for bit, on the native path (both
  packages' C++ encoders, the same xorshift stream) and on the numpy path
  (both packages' generators).  Raw features within 1e-12 relative: pandas'
  default float parser keeps 17 digits counting leading zeros and is not
  correctly rounded, the port's is (a stated divergence of at most ~1e-12
  relative, and only for values below 1e-4).
* Tasks, p-values (on scipy and on each package's fallback), preprocessing
  (float64, 1e-12 relative), splits, ``Pipeline`` arrays and its cache in
  both directions, ``synth`` and the native kNN.
* The codec's string side: ``decode_sequences`` and ``complement_strand``
  equal the JAX package's on seeded codes and strings.
* ``train(pipeline=...)`` end to end on the CPU.
"""

import importlib.util
import os

import numpy as np
import pytest

from embracenet_tpu import TASKS
from embracenet_tpu import api as japi
from embracenet_tpu import runtime as jruntime
from embracenet_tpu.data import codec as jcodec
from embracenet_tpu.data import io as jio
from embracenet_tpu.data import pipeline as jpipe
from embracenet_tpu.data import preprocess as jpre
from embracenet_tpu.data import splits as jsplits
from embracenet_tpu.data import stats as jstats
from embracenet_tpu.data import synth as jsynth
from embracenet_tpu.data import tasks as jtasks
from embracenet_tpu.utils import statcompat as jstatcompat
from embracenet_tpu_torch import api as tapi
from embracenet_tpu_torch import runtime as truntime
from embracenet_tpu_torch.benchkit import write_raw_dataset
from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.data import codec as tcodec
from embracenet_tpu_torch.data import io as tio
from embracenet_tpu_torch.data import pipeline as tpipe
from embracenet_tpu_torch.data import preprocess as tpre
from embracenet_tpu_torch.data import sampling as tsampling
from embracenet_tpu_torch.data import splits as tsplits
from embracenet_tpu_torch.data import stats as tstats
from embracenet_tpu_torch.data import synth as tsynth
from embracenet_tpu_torch.data import tasks as ttasks
from embracenet_tpu_torch.training import cv as tcv
from embracenet_tpu_torch.utils import statcompat as tstatcompat

REL = 1e-12
WIDTHS = {"HEPG2": 14, "K562": 6}


def close64(got, want, rel=REL):
    """Float64 arrays equal within ``rel`` relative (NaN where NaN)."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel,
                               atol=1e-15)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two raw trees: enhancers the minority family (60 vs 90 regions),
    and promoters the minority (90 vs 60)."""
    out = {}
    for name, counts in (("e_minor", (60, 90)), ("p_minor", (90, 60))):
        root = str(tmp_path_factory.mktemp(name) / "data")
        write_raw_dataset(root, counts, WIDTHS, seed=len(out), nan_share=0.05)
        out[name] = root
    return out


@pytest.fixture
def numpy_path(monkeypatch):
    """Both packages on their numpy encoders (no native library)."""
    monkeypatch.setattr(jruntime, "encode_sequences_native", lambda *a, **k: None)
    monkeypatch.setattr(truntime, "encode_sequences_native", lambda *a, **k: None)


def _same_region_sets(a, b):
    np.testing.assert_array_equal(b.codes, a.codes)
    assert sorted(a.features) == sorted(b.features) == sorted(WIDTHS)
    for cell in a.features:
        assert b.feature_names[cell] == a.feature_names[cell]
        close64(b.features[cell], a.features[cell])
        np.testing.assert_array_equal(np.isnan(b.features[cell]),
                                      np.isnan(a.features[cell]))
        assert b.labels[cell].dtype == np.int64
        np.testing.assert_array_equal(b.labels[cell], a.labels[cell])
    for col in ("chrom", "chromStart", "chromEnd"):
        assert list(b.coords[col]) == list(a.coords[col].astype(str))


# ---------------------------------------------------------------------------
# io and the native runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["native", "numpy"])
def test_load_dataset_matches_jax(roots, request, path):
    if path == "native":
        assert jruntime.available() and truntime.available(), \
            truntime.BUILD_ERROR
    else:
        request.getfixturevalue("numpy_path")
    want = jio.load_dataset(roots["e_minor"], seq_rng=7)
    got = tio.load_dataset(roots["e_minor"], seq_rng=7)
    for family in ("enhancers", "promoters"):
        _same_region_sets(want[family], got[family])
        assert np.isnan(got[family].features["HEPG2"]).any()
    fa = os.path.join(roots["e_minor"], "enhancers", "enhancers.fa")
    with open(fa) as fh:
        seqs = fh.read().split("\n")[0::2][:60]
    # the n bases were filled by the stream, and upper case coded as lower
    unknown = np.asarray([[c == "n" for c in s] for s in seqs])
    assert unknown.any()
    lower = [s.lower() for s in seqs]
    known = np.asarray([["acgt".find(c) for c in s] for s in lower])
    np.testing.assert_array_equal(got["enhancers"].codes[~unknown],
                                  known[~unknown])


def test_read_fasta_paths_match_jax(roots):
    fa = os.path.join(roots["e_minor"], "promoters", "promoters.fa")
    for seq_len in (256, None):      # the native parser, the line parser
        want = jio.read_fasta(fa, seq_rng=3, seq_len=seq_len)
        got = tio.read_fasta(fa, seq_rng=3, seq_len=seq_len)
        np.testing.assert_array_equal(got[0], want[0])
        for col in ("chrom", "chromStart", "chromEnd"):
            assert list(got[1][col]) == list(want[1][col])
    with pytest.raises(ValueError, match="sequence length"):
        tio.read_fasta(fa, seq_len=100)


def test_csv_and_bed_cells_read_as_pandas_reads_them(tmp_path):
    csv_path = tmp_path / "K562.csv"
    csv_path.write_text(
        "chrom,chromStart,chromEnd,strand,a,b,c\n"
        "chr1,0,256,+,1.5,,NA\n"
        "chr2,300,556,-,NaN,2,null\n"
        "\n"
        "chr3,600,856,+,-1e-3,N/A,3.25\n"
        "chr4,900,1156,+,0.1,1e308,nan\n")
    want = jio.read_features_csv(str(csv_path))
    got = tio.read_features_csv(str(csv_path))
    close64(got[0], want[0])
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    assert got[1] == want[1] == ["a", "b", "c"]
    for col in want[2].columns:
        assert list(got[2][col]) == list(want[2][col])
    assert got[2]["chromStart"].dtype == np.int64
    bed = tmp_path / "x.bed"
    bed.write_text("chrom\tchromStart\tchromEnd\tK562\tH1\n"
                   "chr1\t0\t256\t1\t0\nchr1\t300\t556\t0\t1\n")
    want, got = jio.read_bed(str(bed)), tio.read_bed(str(bed))
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert list(got[col]) == list(want[col])
    bad = tmp_path / "bad.csv"
    bad.write_text("chrom,a\nchr1,1,2\n")
    with pytest.raises(ValueError, match="fields"):
        tio.read_features_csv(str(bad))


def test_native_knn_equals_knn_sorted(rng):
    assert truntime.available(), truntime.BUILD_ERROR
    # integer-valued rows: many distance ties, broken by row index
    x = rng.integers(0, 3, size=(150, 5)).astype(np.float64)
    for k in (1, 5):
        np.testing.assert_array_equal(truntime.knn_native(x, x, k, True),
                                      tsampling.knn_sorted(x, k))
    y = rng.normal(size=(80, 7))
    np.testing.assert_array_equal(truntime.knn_native(y, y, 5, True),
                                  jruntime.knn_native(y, y, 5, True))
    assert truntime.knn_native(y, y, 65, True) is None


def test_runtime_without_a_compiler_takes_the_numpy_path(monkeypatch):
    monkeypatch.setattr(truntime, "_lib", None)
    monkeypatch.setattr(truntime, "BUILD_ERROR", None)
    monkeypatch.setattr(truntime, "GXX_FLAGS", ("-O3", "--no-such-flag",
                                                "-shared", "-fPIC"))
    assert not truntime.available()
    assert "g++" in truntime.BUILD_ERROR
    assert truntime.encode_sequences_native(["acgt"]) is None
    seqs = ["acgtnNNa" * 4, "nnnnACGT" * 4]
    np.testing.assert_array_equal(
        tcodec.encode_sequences(seqs, 5),
        jcodec.encode_sequences(seqs, 5, native=False))


@pytest.mark.parametrize("shape", [(3, 256), (1, 7), (0, 4)])
def test_decode_sequences_matches_jax_and_inverts_encode(rng, shape):
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    got = tcodec.decode_sequences(codes)
    assert got == jcodec.decode_sequences(codes)
    if shape[0]:
        np.testing.assert_array_equal(tcodec.encode_sequences(got), codes)


def test_complement_strand_matches_jax(rng):
    letters = np.array(list("acgtnACGTN"))
    for n in (0, 1, 17, 256):
        seq = "".join(rng.choice(letters, size=n))
        got = tcodec.complement_strand(seq)
        assert got == jcodec.complement_strand(seq)
        assert got == got.lower() and len(got) == n
    # complemented, not reversed; n stays n
    assert tcodec.complement_strand("AcGtN") == "tgcan"


# ---------------------------------------------------------------------------
# tasks, statistics, preprocessing, splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root,task", [("e_minor", t) for t in TASKS] + [
    ("p_minor", "active_E_vs_active_P"), ("p_minor", "inactive_E_vs_inactive_P")])
def test_get_task_matches_jax(roots, root, task):
    want = jtasks.get_task(jio.load_dataset(roots[root]), task)
    got = ttasks.get_task(tio.load_dataset(roots[root]), task)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.index_fa is None) == (want.index_fa is None)
    for cell in want.features:
        close64(got.features[cell], want.features[cell])
        np.testing.assert_array_equal(got.labels[cell], want.labels[cell])
        assert got.feature_names[cell] == want.feature_names[cell]
        np.testing.assert_array_equal(got.sequence_codes(cell),
                                      want.sequence_codes(cell))
        if want.index_fa is not None:
            np.testing.assert_array_equal(got.index_fa[cell], want.index_fa[cell])
    with pytest.raises(ValueError, match="unknown task"):
        ttasks.get_task(tio.load_dataset(roots[root]), "no_such_task")


def _fallback(module, name, monkeypatch):
    """A fresh copy of a statcompat module on its fallback branch."""
    monkeypatch.setenv("EMBRACENET_NO_SCIPY", "1")
    spec = importlib.util.spec_from_file_location(name, module.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.HAVE_SCIPY is False
    return mod


@pytest.mark.parametrize("branch", ["scipy", "fallback"])
def test_pvalues_match_jax(rng, monkeypatch, branch):
    if branch == "fallback":
        jfb = _fallback(jstatcompat, "_j_statcompat_fallback", monkeypatch)
        tfb = _fallback(tstatcompat, "_t_statcompat_fallback", monkeypatch)
        for mod, fb in ((jstats, jfb), (tstats, tfb)):
            for name in ("chi2_sf", "norm_sf", "rankdata"):
                monkeypatch.setattr(mod, name, getattr(fb, name))
        z = np.linspace(-6, 6, 25)
        close64(tfb.norm_sf(z), jfb.norm_sf(z))
        close64(tfb.chi2_sf(np.abs(z) * 3, df=1), jfb.chi2_sf(np.abs(z) * 3, df=1))
        a, b = rng.normal(size=30), rng.normal(size=40) + 0.3
        close64(tfb.ranksums(a, b), jfb.ranksums(a, b))
        close64(tfb.wilcoxon(a[:12], b[:12]), jfb.wilcoxon(a[:12], b[:12]))
        close64(tfb.wilcoxon(a, b[:30]), jfb.wilcoxon(a, b[:30]))
    else:
        assert tstatcompat.HAVE_SCIPY == jstatcompat.HAVE_SCIPY
    x = rng.normal(size=(120, 9))
    x[:, 3] = np.round(x[:, 3])          # ties
    x[:, 4] = x[:, 0] * 2 + rng.normal(size=120) * 0.05
    y = (rng.random(120) < 0.4).astype(np.int64)
    x[:, 0] += y
    cols = [f"c{j}" for j in range(9)]
    close64(tstats.kruskal_pvalues(x, y), jstats.kruskal_pvalues(x, y))
    close64(tstats.ranksums_pvalues(x, y), jstats.ranksums_pvalues(x, y))
    close64(tstats.spearman_matrix(x), jstats.spearman_matrix(x))
    pairs = tstats.correlated_pairs(x, cols, 0.7)
    assert pairs == jstats.correlated_pairs(x, cols, 0.7) and pairs
    for test in ("kruskal_wallis_test", "wilcoxon_test"):
        assert tstats.uncorrelated_with_label(x, y, cols, test) == \
            jstats.uncorrelated_with_label(x, y, cols, test)
        assert tstats.remove_correlated_features(x, y, cols, pairs, test) == \
            jstats.remove_correlated_features(x, y, cols, pairs, test)


@pytest.mark.parametrize("mean_match", [0, 10])
def test_preprocess_matches_jax(rng, mean_match):
    x = rng.normal(size=(200, 12)) * rng.uniform(0.5, 50, 12)
    y = (rng.random(200) < 0.3).astype(np.int64)
    x[:, :5] += 2 * y[:, None]
    x[:, 6] = x[:, 1] * 3 + rng.normal(size=200) * 0.01
    x[rng.random((200, 12)) < 0.04] = np.nan
    close64(tpre.robust_minmax_scale(x), jpre.robust_minmax_scale(x))
    scaled = jpre.robust_minmax_scale(x)
    want = jpre.iterative_impute(scaled, mean_match_candidates=mean_match)
    got = tpre.iterative_impute(scaled, mean_match_candidates=mean_match)
    close64(got, want)
    assert not np.isnan(got).any()
    cols = [f"f{j}" for j in range(12)]
    for kw in ({}, {"type_test": ["kruskal_wallis_test", "wilcoxon_test"],
                    "intersection": True}):
        xs_j, cs_j = jpre.select_features(want, y, cols, **kw)
        xs_t, cs_t = tpre.select_features(got, y, cols, **kw)
        assert cs_t == cs_j and 0 < len(cs_t) < 12
        close64(xs_t, xs_j)


@pytest.mark.parametrize("augmentation", [False, True])
@pytest.mark.parametrize("hyper_tuning", [False, True])
def test_splits_match_jax(rng, hyper_tuning, augmentation):
    n = 97
    data = {"ffnn": rng.normal(size=(n, 5)),
            "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": (rng.random(n) < 0.08).astype(np.int64)}
    for a, b in zip(tsplits.split_indices(n, hyper_tuning, random_state=11),
                    jsplits.split_indices(n, hyper_tuning, random_state=11)):
        np.testing.assert_array_equal(a, b)
    got = tsplits.split_data(data, hyper_tuning, random_state=11,
                             augmentation=augmentation)
    want = jsplits.split_data(data, hyper_tuning, random_state=11,
                              augmentation=augmentation)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    for (a, b), (c, d) in zip(tsplits.cv_indices(n, 3, 5),
                              jsplits.cv_indices(n, 3, 5)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_synth_matches_jax():
    kw = dict(prevalence=0.2, gate_p=0.5, tab_shift=1.2, n_tab_features=6,
              motif_pos_rate=0.95, motif_bg_rate=0.03, gate_vis=0.3)
    want = jsynth.gated_multimodal_task(300, d=16, seed=4, **kw)
    got = tsynth.gated_multimodal_task(300, d=16, seed=4, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    o_t, o_j = tsynth.oracle_scores(got, **kw), jsynth.oracle_scores(want, **kw)
    for view in ("tab", "seq", "both"):
        np.testing.assert_array_equal(o_t[view], o_j[view])


# ---------------------------------------------------------------------------
# Pipeline, its cache, and train(pipeline=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pipeline_matches_jax_and_caches_cross(roots, tmp_path, writer):
    task = "active_EP_vs_inactive_rest"
    cache = str(tmp_path / "cache")
    make = {"jax": japi.preprocess, "torch": tapi.preprocess}
    first = make[writer](task, root=roots["e_minor"], cache_dir=cache)
    assert os.path.exists(os.path.join(cache, f"task_{task}.npz"))
    other = "torch" if writer == "jax" else "jax"
    fresh = make[other](task, root=roots["e_minor"], cache_dir=None)
    cached = make[other](task, root="no/such/dir", cache_dir=cache)
    assert first.cells() == fresh.cells() == cached.cells() == sorted(WIDTHS)
    for cell in first.cells():
        want = first.cell_data(cell)
        for p in (fresh, cached):
            got = p.cell_data(cell)
            assert p.feature_names[cell] == first.feature_names[cell]
            assert got["ffnn"].dtype == np.float32 and got["ffnn"].shape[1] > 0
            close64(got["ffnn"], want["ffnn"])
            np.testing.assert_array_equal(got["cnn"], want["cnn"])
            np.testing.assert_array_equal(got["y"], want["y"])
        for split in (fresh.return_data(cell), cached.return_data(
                cell, hyper_tuning=True, sequence=True)):
            assert split[0]["y"].dtype == np.int64
    built, loaded = (first, cached) if writer == "torch" else (fresh, cached)
    if writer == "jax":
        assert loaded.walls["load"] == 0 and loaded.walls["cache"] > 0
    assert set(built.walls) == {"load", "scale", "impute", "select", "cache"}
    assert built.walls["impute"] > 0 and built.walls["load"] > 0
    with pytest.raises(ValueError, match="unknown cell line"):
        built.cell_data("A549")


def test_train_runs_from_a_pipeline_on_the_cpu(tmp_path, monkeypatch):
    task = "active_E_vs_inactive_E"
    root = str(tmp_path / "data")
    write_raw_dataset(root, 200, WIDTHS, seed=5)
    pipe = tapi.preprocess(task, root=root, cache_dir=str(tmp_path / "cache"))
    draw = {"FFNN_n_layers": 1, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.0,
            "CNN_n_layers": 1, "CNN_out_channels_l0": 16,
            "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.0,
            "EMBRACENET_embracement_size": 512, "n_post_layers": 0,
            "selection_probabilities_FFNN": 0.5,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    from embracenet_tpu_torch.hpo.samplers import ReplaySampler

    kw = dict(cv_cfg=CVConfig(n_folds=2, n_trials=1,
                              sampler=ReplaySampler([draw, dict(draw, lr=2e-3)])),
              train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=20),
              storage=str(tmp_path / "s.db"), checkpoint_dir=str(tmp_path),
              device="cpu")
    scores = tapi.train("EmbraceNetMultimodal", "HEPG2", task, pipeline=pipe,
                        **kw)
    assert len(scores["final_test_AUPRC_scores"]) == 2
    assert all(np.isfinite(scores["final_test_AUPRC_scores"]))
    data = pipe.cell_data("HEPG2")
    ck = str(tmp_path / tcv.checkpoint_name("HEPG2", "EmbraceNetMultimodal",
                                            task, 0))
    probs = tapi.predict(ck, data, device="cpu")
    assert probs.shape == (len(data["y"]), 2) and np.isfinite(probs).all()
    # data=None and no pipeline: preprocess(task) under ./data, from its cache
    os.makedirs(tmp_path / "cwd")
    monkeypatch.chdir(tmp_path / "cwd")
    os.symlink(root, "data")
    again = tapi.train("EmbraceNetMultimodal", "HEPG2", task,
                       **dict(kw, storage=str(tmp_path / "s.db")))
    assert again["final_test_AUPRC_scores"] == scores["final_test_AUPRC_scores"]
    assert os.path.exists(os.path.join(".embracenet_cache", f"task_{task}.npz"))
    with pytest.raises(ValueError, match="unknown cell line"):
        tapi.train("EmbraceNetMultimodal", "NOPE", task, device="cpu")
