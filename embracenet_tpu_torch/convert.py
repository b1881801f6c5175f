"""Weights carried across: nested dicts of numpy arrays <-> of tensors.

The port keeps the JAX package's parameter layouts, so a JAX-written
checkpoint, or ``jax.tree.map(np.asarray, params)``, becomes the port's
params through :func:`tree_to_torch` as a plain copy.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


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
