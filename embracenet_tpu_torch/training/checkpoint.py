"""Checkpointing: param trees to ``.npz`` with a JSON hyperparameter sidecar
(port of the npz format of ``embracenet_tpu/training/checkpoint.py``).

The format is shared with the JAX package, so a checkpoint written by
either package loads in the other: each leaf is an npz entry named by its
path joined with ``|`` (list items as ``#i``), and ``__meta__`` holds the
JSON meta, whose ``model_params`` carry the flat hyperparameters that
rebuild the architecture.
"""

from __future__ import annotations

import json
import os

import numpy as np

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
