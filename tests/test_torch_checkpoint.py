"""The checkpoint's second backend (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``) against the JAX package's, on the CPU.

The port stores through ``torch.distributed.checkpoint`` where the JAX
package stores through orbax (a stated divergence: neither reads the
other's files), so the two are held to the same round trip: one seeded
tree through each backend gives the same structure (lists as lists, an
empty subtree as ``{}``), dtypes, shapes, values bit for bit and meta.
The multi-rank save is in ``tests/torch_mesh_worker.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_mesh_worker import same_tree

from embracenet_tpu_torch.training import checkpoint as tck


def _orbax_importable():
    # in a subprocess: a broken tensorstore build can kill the importer
    return subprocess.run([sys.executable, "-c", "import orbax.checkpoint"],
                          capture_output=True, timeout=120).returncode == 0


def seeded_tree(seed=0):
    """Nested dicts, a list subtree, float32 / int32 leaves, 0-d leaves
    and an empty ``bn_state``: an FFNN's trees with CNN_LSTM's list."""
    rng = np.random.default_rng(seed)
    return {"params": {"ffnn": {"w0": rng.normal(size=(6, 4)).astype(np.float32),
                                "b0": rng.normal(size=4).astype(np.float32)},
                       "lstm": [{"w_ih": rng.normal(size=(4, 8)).astype(np.float32),
                                 "b_ih": rng.normal(size=8).astype(np.float32)},
                                {"w_ih": rng.normal(size=(2, 8)).astype(np.float32),
                                 "b_ih": rng.normal(size=8).astype(np.float32)}],
                       "steps": rng.integers(0, 9, size=(3,), dtype=np.int32),
                       "scale": np.float32(rng.normal()),
                       "count": np.int32(7)},
            "bn_state": {}}


META = {"model": "FFNN", "model_params": {"lr": 0.01, "FFNN_n_layers": 2}}


def test_round_trip_equals_the_jax_backends(tmp_path):
    if not _orbax_importable():
        pytest.skip("orbax cannot be imported here")
    from embracenet_tpu.training import checkpoint as jck

    tree = seeded_tree()
    jck.save_checkpoint_orbax(str(tmp_path / "jax"), tree, META)
    want, want_meta = jck.load_checkpoint_orbax(str(tmp_path / "jax"))
    tck.save_checkpoint_orbax(str(tmp_path / "port"), tree, META)
    got, got_meta = tck.load_checkpoint_orbax(str(tmp_path / "port"))
    assert same_tree(got, want)
    assert got_meta == want_meta == META
    assert want["bn_state"] == {} and isinstance(want["params"]["lstm"], list)


@pytest.mark.parametrize("meta", [META, None])
def test_round_trip_gives_back_the_tree(tmp_path, meta):
    tree = seeded_tree(1)
    # tensors are saved as their arrays, tuples come back as lists
    saved = dict(tree, extra=(torch.arange(3, dtype=torch.int64),
                              torch.tensor(2.5)))
    path = str(tmp_path / "sub" / "ck/")
    tck.save_checkpoint_orbax(path, saved, meta)
    assert sorted(os.listdir(tmp_path / "sub" / "ck.orbax")) == [
        ".metadata", "__0_0.distcp"]
    got, got_meta = tck.load_checkpoint_orbax(str(tmp_path / "sub" / "ck"))
    assert same_tree(got, dict(tree, extra=[np.arange(3),
                                            np.array(2.5, np.float32)]))
    assert got_meta == (meta or {})


def test_both_backends_load_the_same_trees(tmp_path):
    """The npz backend drops empty subtrees; everything else is equal."""
    tree = seeded_tree(2)
    tck.save_checkpoint(str(tmp_path / "ck"), tree, META)
    tck.save_checkpoint_orbax(str(tmp_path / "ck"), tree, META)
    npz, npz_meta = tck.load_checkpoint(str(tmp_path / "ck"))
    dcp, dcp_meta = tck.load_checkpoint_orbax(str(tmp_path / "ck"))
    assert same_tree(npz, {"params": tree["params"]})
    assert same_tree(dcp, tree)
    assert npz_meta == dcp_meta == META


def test_a_second_save_overwrites(tmp_path):
    path = str(tmp_path / "ck")
    tck.save_checkpoint_orbax(path, {"params": {"old": np.ones(3)}}, {"v": 1})
    # a part of a wider world's earlier save must not survive
    stale = tmp_path / "ck.orbax" / "__3_0.distcp"
    stale.write_bytes(b"stale")
    tree = seeded_tree(3)
    tck.save_checkpoint_orbax(path, tree, {"v": 2})
    got, meta = tck.load_checkpoint_orbax(path)
    assert same_tree(got, tree)
    assert meta == {"v": 2} and not stale.exists()


def test_a_missing_checkpoint_raises(tmp_path):
    """No fallback: loading a path with no checkpoint of this backend
    raises, even where the npz backend has one."""
    tck.save_checkpoint(str(tmp_path / "ck"), seeded_tree(), META)
    with pytest.raises(FileNotFoundError, match="ck.orbax"):
        tck.load_checkpoint_orbax(str(tmp_path / "ck"))
