"""Tracing and profiling hooks (port of ``embracenet_tpu/utils/profiling.py``;
the reference has only tqdm bars): the program's spans and counters, and
``torch.profiler`` traces.

* :func:`annotate` is the program's span.  While a ``torch.profiler``
  records, it is a ``record_function`` region, so it lands in that
  profile's timeline beside the kernels, on their clock, inside the span
  open around it on the thread.  While none records it is a shared no-op
  (one check, well under a microsecond), so spans stay on the hot path
  with no switch.
* :func:`count` adds to in-memory integer counters.  Every call adds to
  the totals; a call made while a profiler records also adds to the traced
  table, so ``counters(traced=True)`` holds what the profiled regions
  counted and nothing else.
* :func:`device_trace` records a profile and writes it as a Chrome trace.

Stated divergences: :func:`device_trace` writes a Chrome trace JSON (open
it in Perfetto, ``chrome://tracing`` or TensorBoard's PyTorch profiler
plugin), where the JAX package writes an xprof trace; and the JAX
package's ``StepTimer`` has no counterpart: spans in the torch profiler
take its place.
"""

from __future__ import annotations

import contextlib
import functools

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()
_TOTALS: dict[str, int] = {}
_TRACED: dict[str, int] = {}


def annotate(name: str):
    """A named span of the program: ``with annotate("engine.step"): ...``.
    A ``record_function`` region while a torch profiler records, else a
    shared no-op context."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def spanned(name: str):
    """Decorator: every call of the function is one :func:`annotate` span
    named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (and to its traced count while a
    profiler records)."""
    _TOTALS[name] = _TOTALS.get(name, 0) + n
    if _profiler_enabled():
        _TRACED[name] = _TRACED.get(name, 0) + n


def counters(traced: bool = False) -> dict:
    """A copy of the counters: every count since the last
    :func:`reset_counters`, or with ``traced`` only those made while a
    profiler recorded.  A counter never counted is absent."""
    return dict(_TRACED if traced else _TOTALS)


def reset_counters() -> None:
    """Set every counter, traced or not, back to nothing."""
    _TOTALS.clear()
    _TRACED.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of the enclosed code: host operations, the
    program's spans, and the card's kernels (CUPTI, which also sees kernels
    launched outside PyTorch, such as the fused embrace kernel) whenever
    CUDA is available.  On exit writes ``<host>_<pid>.<time>.pt.trace.json``
    into ``log_dir``.  Yields the profiler, so a caller can read
    ``key_averages()``."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
