"""Weights carried across: nested dicts of numpy arrays <-> of tensors.

The port keeps the JAX package's parameter layouts, so a JAX-written
checkpoint, or ``jax.tree.map(np.asarray, params)``, becomes the port's
params through :func:`tree_to_torch` as a plain copy.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples with one
    structure (lists and tuples are nodes, as in ``jax.tree.map``: CNN_LSTM
    keeps its LSTM layers in a list)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(tree_map(fn, *(t[i] for t in trees))
                              for i in range(len(trees[0])))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_to_torch(tree, device=None):
    """Nested dict/list/tuple of array-likes -> same structure of tensors on
    ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.array(tree), device=device)


def tree_to_numpy(tree):
    """Nested dict/list/tuple of tensors -> same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
