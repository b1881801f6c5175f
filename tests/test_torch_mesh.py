"""The port's multi-device path on the CPU: ``parallel/mesh.py`` against the
JAX ``make_mesh``, and sharded fits, K-fold CV and the multi-chip example
in gloo worlds of spawned processes against the port's meshless runs (the
counterparts of ``tests/test_mesh.py`` and ``__graft_entry__``'s
``dryrun_multichip`` / ``dryrun_multihost``).

One world of 4 ranks (``tests/torch_mesh_worker.py``, no JAX) runs every
sharded scenario once and writes each rank's results; the tests read them.
Every world runs under a hard timeout that kills its processes.

Tolerances: a trial-axis mesh runs each trial's steps exactly as the
meshless fit does, so it is held bit for bit.  A data axis sums each batch
reduction in another order: every epoch's AUPRC within 1e-4 (the JAX
``test_mesh_fit_matches_unsharded``), losses within 1e-5 relative, final
params within 1e-4 x max|p| (Adam turns the rounding noise of a gradient
that is exactly zero in exact arithmetic, the conv bias under BatchNorm,
into steps of the learning rate's size), CV scores within 1e-5
(``__graft_entry__.py:196-198``).  The checkpoint's DCP backend saves
from every rank into one directory and loads equal on each.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from embracenet_tpu.parallel import mesh as JM
from embracenet_tpu_torch.config import MeshConfig, TrainConfig
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.models import layers
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.parallel import mesh as M
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.modelspec import get_spec

from torch_mesh_worker import MESH_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
WORLD = 4
WORLD_TIMEOUT = 300.0
SHAPE_CASES = [(n, t, d, dcn) for n in (1, 2, 4, 8)
               for t, d, dcn in ((None, None, None), (None, 2, None),
                                 (2, None, None), (n, 1, None), (3, 3, None),
                                 (None, None, 2), (1, 2, 2), (None, 1, 4))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_world")
    M.launch_local([WORKER, str(out)], WORLD, WORLD_TIMEOUT,
                   env={"OMP_NUM_THREADS": "1"})
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return out, ranks


def _jax_mesh(n, t, d, dcn):
    return JM.make_mesh(n_trial=t, n_data=d, devices=jax.devices()[:n],
                        n_dcn=dcn)


@pytest.mark.parametrize("n,t,d,dcn", SHAPE_CASES)
def test_mesh_shape_and_errors_match_jax(n, t, d, dcn):
    try:
        want = _jax_mesh(n, t, d, dcn)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            M.mesh_shape(n, t, d, dcn)
        assert str(got.value) == str(err)
        return
    shape = M.mesh_shape(n, t, d, dcn)
    assert shape == dict(want.shape)
    mesh = M.Mesh(np.arange(n).reshape(tuple(shape.values())), tuple(shape),
                  "cpu")
    assert mesh.axis_names == want.axis_names
    assert M.trial_axes(mesh) == JM.trial_axes(want)
    assert M.trial_device_count(mesh) == JM.trial_device_count(want)


@pytest.mark.parametrize("case", range(len(MESH_CASES)))
def test_make_mesh_in_a_world_of_four(world, case):
    _, ranks = world
    t, d, dcn = MESH_CASES[case]
    got = [r["meshes"][case] for r in ranks]
    try:
        want = _jax_mesh(WORLD, t, d, dcn)
    except ValueError as err:
        assert all(g == {"error": str(err)} for g in got)
        return
    assert all(g["shape"] == dict(want.shape) for g in got)
    assert all(g["trial_axes"] == list(JM.trial_axes(want)) for g in got)
    assert all(g["trial_device_count"] == JM.trial_device_count(want)
               for g in got)
    # every rank has its own coordinates, laid out as JAX lays out devices
    # (rank r at the position of device r)
    ids = np.vectorize(lambda dv: dv.id)(want.devices)
    for r, g in enumerate(got):
        assert tuple(g["coords"].values()) == tuple(
            int(i) for i in np.argwhere(ids == r)[0])
        assert g["device"] == "cpu"
    # the trial blocks tile a population of 8, the data shards 10 columns
    blocks = {tuple(g["trials_of_8"]) for g in got}
    assert sorted(blocks) == [(b * 8 // len(blocks), (b + 1) * 8 // len(blocks))
                              for b in range(len(blocks))]
    n_data = want.shape["data"]
    cols = sorted({tuple(g["columns_of_10"]) for g in got})
    per = -(-10 // n_data)
    assert cols == [(k * per, (k + 1) * per) for k in range(n_data)]
    # global_from_host_local: the same pieces as the slices
    whole = np.arange(16.).reshape(8, 2)
    plan = np.pad(np.arange(30.).reshape(3, 10), ((0, 0), (0, n_data * per - 10)))
    for g in got:
        lo, hi = g["trials_of_8"]
        np.testing.assert_array_equal(g["piece_trials"], whole[lo:hi])
        lo, hi = g["columns_of_10"]
        np.testing.assert_array_equal(g["piece_columns"], plan[:, lo:hi])
        assert g["replicated"]


def test_meshes_without_a_world():
    """A 1 x 1 mesh needs no process group; a wider one raises naming
    init_distributed; resolve_mesh takes every form the JAX package takes."""
    one = M.make_mesh(1, 1, device_type="cpu")
    assert one.shape == {"trial": 1, "data": 1} and one.group("data") is None
    assert one.device == torch.device("cpu") and M.is_writer(one)
    with pytest.raises(ValueError, match="init_distributed"):
        M.make_mesh(2, 1, devices=[0, 1], device_type="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        M.resolve_mesh(MeshConfig(2, 1), "cpu")
    assert M.resolve_mesh(None, "cpu") is None
    assert M.resolve_mesh(MeshConfig(), "cpu") is None
    assert M.resolve_mesh("auto", "cpu") is None         # a world of one
    assert M.resolve_mesh(one, "cpu") is one             # a Mesh passes
    with pytest.raises(ValueError, match="contradicts"):
        M.resolve_mesh(one, "cuda")
    with pytest.raises(TypeError, match="MeshConfig"):
        M.resolve_mesh(object(), "cpu")


def test_fit_on_a_one_by_one_mesh_equals_the_meshless_fit():
    rng = np.random.default_rng(4)
    data = {"ffnn": rng.normal(size=(40, 4)).astype(np.float32),
            "y": (rng.random(40) < 0.4).astype(np.int64)}
    spec = get_spec("FFNN", in_features_ffnn=4)
    flats = [tspace.sample_params("FFNN", np.random.default_rng(t))
             for t in range(2)]
    hps = [tspace.params_to_hp("FFNN", f) for f in flats]
    opts = [tspace.optimizer_hp(f) for f in flats]
    cfg = TrainConfig(num_epochs=2, epoch_chunk=1, batch_size=20)
    plain = engine.fit(spec, hps, opts, data, data, cfg, device="cpu")
    meshed = engine.fit(spec, hps, opts, data, data, cfg,
                        mesh=M.make_mesh(1, 1, device_type="cpu"))
    assert meshed.auprc_test == plain.auprc_test
    assert meshed.loss_train == plain.loss_train
    for k, v in plain.params.items():
        assert torch.equal(meshed.params[k], v)


def test_a_padded_population_returns_its_real_trials_as_meshless(world):
    for r in world[1]:
        f = r["ffnn_padded"]
        assert f["n_params"] == 3 and len(f["mesh"]["auprc_test"]) == 3
        assert f["mesh"] == f["plain"]
        assert f["params"]["equal"]


def test_a_trial_mesh_equals_the_meshless_fit_bit_for_bit(world):
    for r in world[1]:
        e = r["embracenet"]
        assert e["trial_4x1"]["hist"] == e["plain"]
        assert e["trial_4x1"]["params"]["equal"]


@pytest.mark.parametrize("name", ["data_2x2", "data_1x4"])
def test_a_data_mesh_matches_the_meshless_fit(world, name):
    for r in world[1]:
        e = r["embracenet"]
        got, want = e[name]["hist"], e["plain"]
        for key in ("auprc_train", "auprc_test"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
        assert got["epochs"] == want["epochs"]
        p = e[name]["params"]
        assert p["max_abs"] <= 1e-4 * p["max_p"], p


def test_a_dcn_mesh_equals_the_flat_mesh(world):
    for r in world[1]:
        e = r["embracenet"]
        assert e["dcn_2x1x2"]["hist"] == e["data_2x2"]["hist"]
        assert e["dcn_2x1x2"]["params_vs_2x2"]["equal"]


@pytest.mark.parametrize("scenario", ["ffnn_padded", "embracenet", "kfold"])
def test_every_rank_returns_the_same_results(world, scenario):
    ranks = world[1]
    assert all(r[scenario] == ranks[0][scenario] for r in ranks[1:])


def test_kfold_on_a_mesh_matches_the_meshless_fused_run(world):
    for r in world[1]:
        k = r["kfold"]
        for key in ("final_test_AUPRC_scores", "final_train_AUPRC_scores"):
            np.testing.assert_allclose(k["mesh"][key], k["plain"][key],
                                       rtol=0, atol=1e-5)
        assert abs(k["mesh"]["average_CV_AUPRC"]
                   - k["plain"]["average_CV_AUPRC"]) <= 1e-5
        assert k["resumed"] == k["mesh"]        # every fold from rank 0's files


def test_only_rank_zero_writes_studies_and_checkpoints(world):
    out, _ = world
    written = sorted(os.listdir(out / "rank0" / "mesh"))
    assert "best_.npz" in written and len(written) == 10   # 6 trials, 3 folds
    assert os.path.exists(out / "rank0" / "mesh.db")
    for r in range(1, WORLD):
        assert not os.path.exists(out / f"rank{r}" / "mesh")
        assert not os.path.exists(out / f"rank{r}" / "mesh.db")
        assert os.path.exists(out / f"rank{r}" / "plain.db")   # meshless: all


def test_every_rank_saves_its_part_of_one_checkpoint_and_loads_it_whole(world):
    """``save_checkpoint_orbax(mesh=)`` from all 4 ranks with the whole
    tree: one ``.metadata``, a part per rank, and every rank's load equal
    to the tree (leaves, dtypes, 0-d leaves, the empty ``bn_state``) and
    its meta."""
    for r in world[1]:
        c = r["checkpoint"]
        assert c["files"] == [".metadata"] + [f"__{k}_0.distcp"
                                              for k in range(WORLD)]
        assert c["equal"] and c["meta"] == {"model": "FFNN"}


def test_a_meshless_save_inside_the_world_makes_no_collective(world):
    """One rank of the initialised world saves and loads with
    ``mesh=None`` while the others wait: it writes alone and calls no
    collective of ``torch.distributed``."""
    alone = [r["checkpoint"]["alone"] for r in world[1]
             if "alone" in r["checkpoint"]]
    assert len(alone) == 1
    assert alone[0]["collectives"] == []
    assert alone[0]["files"] == [".metadata", "__0_0.distcp"]
    assert alone[0]["equal"] and alone[0]["meta"] == {"model": "FFNN"}


@pytest.mark.parametrize("fn", [K.fused_embrace, K.fused_embrace_fulle])
@pytest.mark.parametrize("rows", [(0, 37), (5, 37), (20, 43)])
def test_row_base_draws_the_whole_launch_rows(fn, rows):
    """The plain path (CPU) at ``row_base=r`` on rows [r, r + b) equals
    those rows of the launch on the whole batch of 37, bit for bit; rows
    past the batch (a padded shard) draw on past it."""
    lo, hi = rows
    g = torch.Generator().manual_seed(0)
    B, D0, D1, E = 37, 8, 24, 40
    x0, x1 = torch.randn(B + 6, D0, generator=g), torch.randn(B + 6, D1, generator=g)
    w0, w1 = torch.randn(D0, E, generator=g), torch.randn(D1, E, generator=g)
    b0, b1 = torch.randn(E, generator=g), torch.randn(E, generator=g)
    p0 = torch.rand(B + 6, generator=g)
    e_mask = (torch.arange(E) < 33).float()
    whole = fn(x0[:B], x1[:B], w0, b0, w1, b1, p0[:B], e_mask, 9)
    part = fn(x0[lo:hi], x1[lo:hi], w0, b0, w1, b1, p0[lo:hi], e_mask, 9,
              row_base=lo)
    n = min(hi, B) - lo
    for got, want in zip(part, whole):
        assert torch.equal(got[:n], want[lo:lo + n])
    with pytest.raises(ValueError, match="row_base"):
        fn(x0[:B], x1[:B], w0, b0, w1, b1, p0[:B], e_mask, 9, row_base=-1)


@pytest.mark.parametrize("lo,b", [(0, 5), (5, 5), (10, 5), (12, 4)])
def test_a_shard_draws_the_whole_batch_rows(lo, b):
    """``layers.rand`` and ``layers.dropout`` of a shard take the rows of
    the whole batch's draw (13 rows), and rows past it are padding."""
    shard = M.BatchShard(lo, 13, 3, None)
    whole = torch.rand((13, 6), generator=torch.Generator().manual_seed(2))
    got = layers.rand((b, 6), torch.Generator().manual_seed(2), "cpu", shard)
    n = min(lo + b, 13) - lo
    assert torch.equal(got[:n], whole[lo:lo + n])
    assert torch.equal(got[n:], torch.zeros(b - n, 6))
    x = torch.ones(13, 6)
    drop_whole = layers.dropout(x, 0.5, torch.Generator().manual_seed(2), True)
    drop = layers.dropout(x[:b], 0.5, torch.Generator().manual_seed(2), True,
                          shard)
    assert torch.equal(drop[:n], drop_whole[lo:lo + n])


def test_the_multichip_example_runs_on_two_cpu_ranks():
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_multichip_sweep.py"),
         "--cpu-procs", "2", "--cells", "K562", "--timeout", "240"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "world: 2 ranks, backend gloo, cpu" in proc.stdout
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K562:")]
    score = float(line[0].split("=")[1])
    assert 0.0 <= score <= 1.0
