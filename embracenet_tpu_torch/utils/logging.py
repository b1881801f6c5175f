"""Structured logging (port of ``embracenet_tpu/utils/logging.py``; the
reference has no logging framework, only prints).  One logger per
subsystem under ``embracenet_tpu_torch``; the level comes from the
``EMBRACENET_LOG`` environment variable (INFO by default)."""

from __future__ import annotations

import logging
import os
import sys

ROOT = "embracenet_tpu_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname).1s: %(message)s"


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name`` (e.g. ``"embracenet_tpu_torch.sweep"``).  The
    first call gives the package's root logger one stderr handler; later
    calls add none."""
    root = logging.getLogger(ROOT)
    if not any(getattr(h, "_embracenet", False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        handler._embracenet = True
        root.addHandler(handler)
        root.setLevel(os.environ.get("EMBRACENET_LOG", "INFO").upper())
        root.propagate = False
    return logging.getLogger(name)
