"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: hyperparameter constructors and the numpy bridge between the two."""

from __future__ import annotations

import jax
import numpy as np
import torch

from embracenet_tpu_torch.convert import tree_to_torch

IN_FEATURES = 16


def hp_ffnn(n_layers, widths, dropout=None):
    return {"n_layers": np.int32(n_layers),
            "widths": np.asarray(widths, np.int32),
            "dropout": np.asarray(dropout or [0.0] * 4, np.float32)}


def hp_cnn(n_layers, channels, kernels, dropout=None):
    return {"n_layers": np.int32(n_layers),
            "channels": np.asarray(channels, np.int32),
            "kernels": np.asarray(kernels, np.int32),
            "dropout": np.asarray(dropout or [0.0] * 4, np.float32)}


def flat_embracenet(p_ffnn, n_post=1, cnn_layers=2, ffnn_layers=2,
                    embrace_size=512):
    """Small EmbraceNetMultimodal flat params (reference names)."""
    flat = {"FFNN_n_layers": ffnn_layers, "CNN_n_layers": cnn_layers,
            "EMBRACENET_embracement_size": embrace_size,
            "n_post_layers": n_post,
            "selection_probabilities_FFNN": p_ffnn,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    for i, (w, c, k) in enumerate(zip((64, 32, 16, 4), (16, 32, 64, 128),
                                      (5, 11, 15, 5))):
        flat[f"FFNN_n_units_l{i}"] = w
        flat[f"CNN_out_channels_l{i}"] = c
        flat[f"CNN_kernel_size_l{i}"] = k
    flat["EMBRACENET_n_units_l0"] = 64
    flat["EMBRACENET_n_units_l1"] = 32
    return flat


def to_torch(tree):
    """JAX tree -> numpy -> the port's tensors (CPU)."""
    return tree_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)
