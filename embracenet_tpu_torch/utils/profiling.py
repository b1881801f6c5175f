"""Tracing and profiling hooks (port of ``embracenet_tpu/utils/profiling.py``;
the reference has only tqdm bars): ``torch.profiler`` traces and
lightweight step timers.

Stated divergence: :func:`device_trace` writes a Chrome trace JSON (open it
in Perfetto, ``chrome://tracing`` or TensorBoard's PyTorch profiler
plugin), where the JAX package writes an xprof trace.
"""

from __future__ import annotations

import contextlib
import json
import time


class StepTimer:
    """Accumulates wall-clock per named phase; cheap enough to always run."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(self.totals[name]
                                        / self.counts[name] * 1e3, 3)}
                for name in self.totals}

    def dump(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=1)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the enclosed code: host operations, and
    the card's kernels (CUPTI, which also sees kernels launched outside
    PyTorch, such as the fused embrace kernel) whenever CUDA is available.
    On exit writes ``<host>_<pid>.<time>.pt.trace.json`` into ``log_dir``.
    Yields the profiler, so a caller can read ``key_averages()``."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a device trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield
