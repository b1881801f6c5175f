"""One rank of a gloo world on the CPU for ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_worker.py OUT_DIR

started by ``parallel.mesh.launch_local`` (which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  It imports no JAX (the chip
machine has none, and ``tests/conftest.py`` is not loaded here): it runs
the port's sharded fits and their meshless counterparts in this process,
and the checkpoint's DCP backend across the world, and writes
``OUT_DIR/rank{r}.json``, which the test reads.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from embracenet_tpu_torch.config import CVConfig, TrainConfig  # noqa: E402
from embracenet_tpu_torch.convert import tree_leaves, tree_to_numpy  # noqa: E402
from embracenet_tpu_torch.hpo import space  # noqa: E402
from embracenet_tpu_torch.parallel import mesh as M  # noqa: E402
from embracenet_tpu_torch.training import engine  # noqa: E402
from embracenet_tpu_torch.training.checkpoint import (  # noqa: E402
    load_checkpoint_orbax, save_checkpoint_orbax)
from embracenet_tpu_torch.training.cv import KfoldCV  # noqa: E402
from embracenet_tpu_torch.training.modelspec import get_spec  # noqa: E402

# make_mesh cases on a world of 4: (n_trial, n_data, n_dcn)
MESH_CASES = ((None, None, None), (4, 1, None), (2, 2, None), (1, 4, None),
              (None, 2, None), (2, None, None), (3, 3, None), (2, 1, None),
              (None, None, 2), (1, 2, 2), (2, 1, 2), (2, 2, 2), (None, None, 3))


def history(res):
    return {"loss": res.loss_train, "auprc_train": res.auprc_train,
            "auprc_test": res.auprc_test, "f1": res.f1_precision_recall,
            "epochs": res.epochs_run}


def param_diff(got, want):
    """Max |got - want| over every param and BN leaf, max |want| of the
    params, and whether every leaf is equal bit for bit."""
    g = [np.asarray(a, np.float64) for a in
         tree_leaves(tree_to_numpy((got.params, got.bn_state)))]
    w = [np.asarray(a, np.float64) for a in
         tree_leaves(tree_to_numpy((want.params, want.bn_state)))]
    p = tree_leaves(tree_to_numpy(want.params))
    return {"max_abs": max(float(np.abs(a - b).max()) for a, b in zip(g, w)),
            "max_p": max(float(np.abs(a).max()) for a in p),
            "equal": all(np.array_equal(a, b) for a, b in zip(g, w))}


def meshes():
    out = []
    for t, d, dcn in MESH_CASES:
        try:
            m = M.make_mesh(t, d, n_dcn=dcn)
        except ValueError as err:
            out.append({"error": str(err)})
            continue
        out.append({"shape": m.shape, "axis_names": list(m.axis_names),
                    "coords": m.coords, "trial_axes": list(M.trial_axes(m)),
                    "trial_device_count": M.trial_device_count(m),
                    "trials_of_8": [M.trial_sharding(m, 8).start,
                                    M.trial_sharding(m, 8).stop],
                    "columns_of_10": [M.batch_sharding(m, 10).start,
                                      M.batch_sharding(m, 10).stop],
                    # a [2, 8] population tree and a [3, 10] plan: this
                    # rank's trials and its zero-padded columns
                    "piece_trials": M.global_from_host_local(
                        {"w": torch.arange(16.).reshape(8, 2)}, m,
                        "trial")["w"].tolist(),
                    "piece_columns": M.global_from_host_local(
                        torch.arange(30.).reshape(3, 10), m, "data").tolist(),
                    "replicated": M.global_from_host_local([1, 2], m) == [1, 2],
                    "device": str(m.device)})
    return out


def ffnn_padded():
    """3 FFNN trials on a 4-wide trial axis (JAX
    ``test_fit_mesh_pads_nondivisible_population``)."""
    rng = np.random.default_rng(0)
    data = {"ffnn": rng.normal(size=(40, 4)).astype(np.float32),
            "y": (rng.random(40) < 0.4).astype(np.int64)}
    spec = get_spec("FFNN", in_features_ffnn=4)
    flats = [space.sample_params("FFNN", np.random.default_rng(t)) for t in range(3)]
    hps = [space.params_to_hp("FFNN", f) for f in flats]
    opts = [space.optimizer_hp(f) for f in flats]
    cfg = TrainConfig(num_epochs=2, epoch_chunk=1, batch_size=20)
    plain = engine.fit(spec, hps, opts, data, data, cfg, seed=3, device="cpu")
    meshed = engine.fit(spec, hps, opts, data, data, cfg, seed=3,
                        mesh=M.make_mesh(4, 1))
    return {"plain": history(plain), "mesh": history(meshed),
            "n_params": int(next(iter(meshed.params.values())).shape[0]),
            "params": param_diff(meshed, plain)}


def embracenet_meshes():
    """Two EmbraceNet trials with dropout and selection p = 0.5 through the
    fused path (the kernel's plain version on the CPU), meshless and on a
    trial mesh, data meshes and a ('dcn', 'trial', 'data') mesh."""
    rng = np.random.default_rng(1)
    n, d = 100, 12
    y = (rng.random(n) < 0.3).astype(np.int64)
    w = rng.normal(size=d)
    data = {"ffnn": (rng.normal(size=(n, d))
                     + np.outer(y * 2 - 1, w) * 0.9).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8), "y": y}
    train = {k: v[:70] for k, v in data.items()}
    test = {k: v[70:] for k, v in data.items()}
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=d)
    hps, opts = [], []
    for ff, cnn in ((32, 16), (16, 32)):
        flat = {"FFNN_n_layers": 2, "CNN_n_layers": 1,
                "EMBRACENET_embracement_size": 512, "n_post_layers": 1,
                "selection_probabilities_FFNN": 0.5, "optimizer": "Adam",
                "lr": 1e-3, "weight_decay": 1e-4,
                "FFNN_n_units_l0": ff, "FFNN_n_units_l1": 16,
                "FFNN_dropout_l0": 0.3, "FFNN_dropout_l1": 0.2,
                "CNN_out_channels_l0": cnn, "CNN_kernel_size_l0": 5,
                "CNN_dropout_l0": 0.25, "EMBRACENET_n_units_l0": 32,
                "EMBRACENET_dropout_l0": 0.4}
        hps.append(space.params_to_hp("EmbraceNetMultimodal", flat))
        opts.append(space.optimizer_hp(flat))
    # batch 14: balanced plans and eval batches of widths no data axis
    # divides, so shards carry masked padding
    cfg = TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=14,
                      width_buckets=True)

    def fit(mesh=None):
        return engine.fit(spec, hps, opts, train, test, cfg, seed=11,
                          mesh=mesh, device="cpu")

    plain = fit()
    out = {"plain": history(plain)}
    for name, m in (("trial_4x1", M.make_mesh(4, 1)), ("data_2x2", M.make_mesh(2, 2)),
                    ("data_1x4", M.make_mesh(1, 4)),
                    ("dcn_2x1x2", M.make_mesh(1, 2, n_dcn=2))):
        res = fit(m)
        out[name] = {"hist": history(res), "params": param_diff(res, plain),
                     "params_vs_2x2": None}
        out[name]["_res"] = res
    out["dcn_2x1x2"]["params_vs_2x2"] = param_diff(out["dcn_2x1x2"]["_res"],
                                                   out["data_2x2"]["_res"])
    for v in out.values():
        v.pop("_res", None)
    return out


def kfold(out_dir, rank):
    """Fold-fused K-fold CV (3 folds x 2 trials) meshless and on a 2 x 2
    mesh, then the same mesh call again, which resumes every fold from
    rank 0's checkpoints.  Every rank writes under its own directory, so
    the test sees which ranks wrote."""
    rng = np.random.default_rng(2)
    n, d = 90, 8
    y = (rng.random(n) < 0.3).astype(np.int64)
    w = rng.normal(size=d)
    data = {"ffnn": (rng.normal(size=(n, d))
                     + np.outer(y * 2.0 - 1.0, w) * 0.8).astype(np.float32),
            "y": y}
    t_cfg = TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=20,
                        width_buckets=True)
    base = os.path.join(out_dir, f"rank{rank}")

    def run(sub, mesh, fuse, resume=False):
        return KfoldCV()(data, "FFNN", task="active_P_vs_inactive_P",
                         cell_line="K562",
                         cv_cfg=CVConfig(n_folds=3, n_trials=2, sampler="random",
                                         fuse_folds=fuse),
                         train_cfg=t_cfg, storage=os.path.join(base, f"{sub}.db"),
                         checkpoint_dir=os.path.join(base, sub),
                         test_model_path="best_", resume=resume, mesh=mesh,
                         device="cpu")

    os.makedirs(base, exist_ok=True)
    plain = run("plain", None, True)
    mesh = M.make_mesh(2, 2)
    meshed = run("mesh", mesh, None)          # None: fused under a mesh
    again = run("mesh", mesh, None, resume=True)
    return {"plain": plain, "mesh": meshed, "resumed": again}


# the torch.distributed calls a save that writes alone must not make
COLLECTIVES = ("barrier", "all_reduce", "broadcast", "all_gather", "gather",
               "scatter", "reduce_scatter", "all_to_all", "all_gather_object",
               "gather_object", "broadcast_object_list", "scatter_object_list")


def checkpoint(out_dir, rank):
    """The second checkpoint backend in this world: every rank saves the
    whole seeded tree with ``mesh=`` a 4 x 1 mesh into one directory, then
    loads it alone; then rank 1 alone saves and loads with ``mesh=None``
    while the others wait at a barrier, counting the collectives it calls."""
    rng = np.random.default_rng(5)
    tree = {"params": {f"w{i}": rng.normal(size=(32, 16)).astype(np.float32)
                       for i in range(4)}
            | {"lstm": [{"b": rng.normal(size=8).astype(np.float32)}],
               "steps": np.int32(9), "n": np.arange(5, dtype=np.int32)},
            "bn_state": {}}
    meta = {"model": "FFNN"}
    path = os.path.join(out_dir, "dcp")
    save_checkpoint_orbax(path, tree, meta, mesh=M.make_mesh(4, 1))
    got, got_meta = load_checkpoint_orbax(path)
    out = {"files": sorted(os.listdir(path + ".orbax")),
           "equal": same_tree(got, tree), "meta": got_meta}
    torch.distributed.barrier()
    if rank == 1:
        calls = []
        real = {n: getattr(torch.distributed, n) for n in COLLECTIVES}
        for n, fn in real.items():
            setattr(torch.distributed, n,
                    lambda *a, _n=n, _fn=fn, **k: calls.append(_n) or _fn(*a, **k))
        try:
            alone = os.path.join(out_dir, "alone")
            save_checkpoint_orbax(alone, tree, meta)
            got, got_meta = load_checkpoint_orbax(alone)
        finally:
            for n, fn in real.items():
                setattr(torch.distributed, n, fn)
        out["alone"] = {"collectives": calls, "equal": same_tree(got, tree),
                        "meta": got_meta,
                        "files": sorted(os.listdir(alone + ".orbax"))}
    torch.distributed.barrier()
    return out


def same_tree(got, want) -> bool:
    """The same nesting of dicts and lists and, at every leaf, an array of
    the same dtype, shape and values."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(same_tree(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(map(same_tree, got, want)))
    return (isinstance(got, np.ndarray) and got.dtype == want.dtype
            and got.shape == want.shape and np.array_equal(got, want))


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    M.init_distributed(backend="gloo")
    rank = torch.distributed.get_rank()
    result = {"rank": rank, "meshes": meshes(), "ffnn_padded": ffnn_padded(),
              "embracenet": embracenet_meshes(), "kfold": kfold(out_dir, rank),
              "checkpoint": checkpoint(out_dir, rank)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh, default=float)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
