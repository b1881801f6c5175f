"""Results helpers (port of ``baseline_auprc`` from
``embracenet_tpu/training/results.py``; the ``ResultsDict`` artifact comes
with the CV slice)."""

from __future__ import annotations

import numpy as np


def baseline_auprc(y, floor: float = 0.1) -> float:
    """Positive prevalence floored at 0.1 (`visual/visual.py:81-96`)."""
    y = np.asarray(y)
    return float(max(float((y == 1).mean()), floor))
