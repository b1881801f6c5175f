"""The program's own spans and counters, read from a traced stretch.

The port marks its phases with ``utils.profiling.annotate`` spans, which
the profiler records beside the kernels and on their clock, so
:func:`benchmark.core.trace.reduce` keeps them among the stretch's
``host`` records; and it counts events with ``utils.profiling.count``,
whose traced table holds what the program counted while the stretch was
profiled (the only profiled region of a run).

:func:`idle_pct` gives the share of the stretch in which the device was
idle while a span of one name was open; :func:`program_counters` the
traced counts.  A program without such spans or counters (one older than
them) gives None and ``{}``, so a reader built on them reports nothing
rather than raising.
"""

from __future__ import annotations

from benchmark.core.trace import _union, idle_gaps


def span_intervals(rec, name: str):
    """``[[start, end]]``: the union of the intervals of the spans named
    ``name`` in ``rec["host"]``, clipped to the stretch."""
    lo, hi = rec["stretch"]
    return _union([h for h in rec["host"] if h[0] == name], lo, hi)


def idle_in(rec, name: str):
    """Seconds of the stretch with no device operation and a span named
    ``name`` open, or None where the stretch has no device operation or no
    such span."""
    spans = span_intervals(rec, name)
    if not rec["device"] or not spans:
        return None
    gaps, total, i, j = idle_gaps(rec), 0.0, 0, 0
    while i < len(gaps) and j < len(spans):
        s, e = max(gaps[i][0], spans[j][0]), min(gaps[i][1], spans[j][1])
        total += max(0.0, e - s)
        if gaps[i][1] < spans[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(rec, name: str):
    """:func:`idle_in` as a share (%) of the stretch's wall, or None."""
    idle = idle_in(rec, name)
    if idle is None or rec["stretch_s"] <= 0:
        return None
    return 100.0 * idle / rec["stretch_s"]


def program_counters() -> dict:
    """What the program counted while a profiler recorded (``{}`` where it
    keeps no counters)."""
    try:
        from embracenet_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return read(traced=True) if read is not None else {}
