"""The benchmark's inputs, made from its seed: ``bench.py``'s learnable
windows (a copy of ``benchkit.make_data``): epigenomic features that carry
the label along one random direction, and uniform 2-bit base codes."""

from __future__ import annotations

import numpy as np


def make_data(n: int, d: int, rng: np.random.Generator,
              prevalence: float = 0.15) -> dict:
    """``n`` windows of ``d`` features: ``{"ffnn": float32 [n, d], "cnn":
    uint8 [n, 256] codes in 0..3, "y": int64 [n]}``, ``prevalence`` the
    share of positives."""
    y = (rng.random(n) < prevalence).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w) * 0.5).astype(np.float32)
    codes = rng.integers(0, 4, size=(n, 256)).astype(np.uint8)
    return {"ffnn": x, "cnn": codes, "y": y}
