"""Checkpointing: param trees to ``.npz`` with a JSON hyperparameter sidecar
(port of ``embracenet_tpu/training/checkpoint.py``).

The npz format is shared with the JAX package, so a checkpoint written by
either package loads in the other: each leaf is an npz entry named by its
path joined with ``|`` (list items as ``#i``), and ``__meta__`` holds the
JSON meta, whose ``model_params`` carry the flat hyperparameters that
rebuild the architecture.

The second backend (:func:`save_checkpoint_orbax`,
:func:`load_checkpoint_orbax`) keeps the JAX package's names and its
``path + ".orbax"`` directory, and stores the same trees and meta through
``torch.distributed.checkpoint`` (DCP), whose layout lets every rank of a
mesh write its part.  Stated divergence: its files are DCP's, not orbax's,
so neither package reads the other's checkpoints of this backend.  It
has no ``EMBRACENET_NO_ORBAX`` switch: the JAX package's guards the import
of orbax's tensorstore, and DCP ships with torch.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

import numpy as np
import torch

from embracenet_tpu_torch.convert import tree_to_numpy
from embracenet_tpu_torch.parallel.mesh import barrier, is_writer

_SEP = "|"
_LIST_MARK = "#"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_LIST_MARK}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def restore_lists(node):
    """Nested dicts -> the same with every dict whose keys are all list
    items (``#0``, ``#1``, ...) turned back into a list."""
    if not isinstance(node, dict):
        return node
    node = {k: restore_lists(v) for k, v in node.items()}
    if node and all(k.startswith(_LIST_MARK) for k in node):
        return [node[f"{_LIST_MARK}{i}"] for i in range(len(node))]
    return node


def _unflatten(flat: dict):
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return restore_lists(tree)


def save_checkpoint(path: str, trees: dict, meta: dict | None = None,
                    mesh=None):
    """``trees``: name -> tree of tensors or arrays (e.g. {"params": ...,
    "bn_state": ...}).  Under a ``mesh`` rank 0 alone writes, and every
    rank waits until it has."""
    if is_writer(mesh):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {}
        for name, tree in trees.items():
            for k, v in _flatten(tree_to_numpy(tree)).items():
                flat[f"{name}{_SEP}{k}" if k else name] = v
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 __meta__=np.frombuffer(
                     json.dumps(meta or {}, default=float).encode(), np.uint8),
                 **flat)
    barrier(mesh)


def _json_bytes(obj) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(
        json.dumps(obj, default=float).encode(), np.uint8).copy())


def _skeleton(tree):
    """``tree``'s structure as JSON: dicts as objects, lists and tuples as
    arrays, each leaf as its number of dimensions.  It keeps what the flat
    leaves alone lose: empty subtrees, and 0-d leaves (DCP stores a 0-d
    tensor as one of shape [1])."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return tree.ndim


def _fill(skeleton, flat: dict, prefix: str):
    """The tree of ``skeleton`` with the leaves of ``flat`` (keys as
    :func:`_flatten` names them, under ``prefix``)."""
    if isinstance(skeleton, dict):
        return {k: _fill(v, flat, f"{prefix}{k}{_SEP}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_fill(v, flat, f"{prefix}{_LIST_MARK}{i}{_SEP}")
                for i, v in enumerate(skeleton)]
    leaf = flat[prefix.rstrip(_SEP)]
    return leaf.reshape(()) if skeleton == 0 else leaf


def _orbax_dir(path: str) -> str:
    return os.path.abspath(path.rstrip("/")) + ".orbax"


def save_checkpoint_orbax(path: str, trees: dict, meta: dict | None = None,
                          mesh=None):
    """The second backend: ``trees`` (name -> tree of tensors or arrays)
    and ``meta`` into the directory ``path + ".orbax"`` through
    ``torch.distributed.checkpoint``, overwriting a checkpoint there.

    Under a ``mesh`` of more than one rank every rank calls this with the
    whole tree, as every JAX process calls orbax's save; DCP writes each
    replicated leaf once, so each rank writes a part (``__r_0.distcp``) and
    rank 0 the ``.metadata``.  The tree must be whole and equal on every
    rank: DCP silently keeps one rank's copy of a leaf that differs.
    Without a mesh, or on a mesh of one rank, this process writes alone
    and enters no collective, even inside an initialised world.  A failed
    save raises; nothing falls back to the npz backend."""
    import torch.distributed.checkpoint as dcp

    out = _orbax_dir(path)
    trees = tree_to_numpy(trees)
    flat = {f"trees{_SEP}{k}": torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _flatten(trees).items()}
    flat["tree_json"] = _json_bytes(_skeleton(trees))
    flat["meta_json"] = _json_bytes(meta or {})
    if is_writer(mesh):
        # DCP overwrites files by name only: a wider world's parts would stay
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
    barrier(mesh)
    alone = mesh is None or mesh.size == 1
    with warnings.catch_warnings():
        # DCP warns that a no_dist save runs in a single process: intended
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        dcp.save(flat, storage_writer=dcp.FileSystemWriter(out), no_dist=alone)


def load_checkpoint_orbax(path: str):
    """-> (trees dict of numpy arrays, meta dict) of
    :func:`save_checkpoint_orbax`: the saved structure (lists as lists,
    empty subtrees as ``{}``) and dtypes, 0-d leaves as 0-d arrays.  Any
    rank may load alone (no collective)."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(_orbax_dir(path))
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
            for k, m in reader.read_metadata().state_dict_metadata.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        dcp.load(flat, storage_reader=reader, no_dist=True)
    flat = {k: v.numpy() for k, v in flat.items()}
    skeleton = json.loads(bytes(flat.pop("tree_json")).decode())
    meta = json.loads(bytes(flat.pop("meta_json")).decode())
    return _fill(skeleton, flat, f"trees{_SEP}"), meta


def load_checkpoint(path: str):
    """-> (trees dict of numpy arrays, meta dict)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    grouped: dict = {}
    for k, v in flat.items():
        name, _, rest = k.partition(_SEP)
        grouped.setdefault(name, {})[rest] = v
    trees = {name: (_unflatten(sub) if list(sub) != [""] else sub[""])
             for name, sub in grouped.items()}
    return trees, meta
