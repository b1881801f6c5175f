"""The traced stretch: ``torch.profiler`` over a short steady stretch after
the measured window, reduced to the records the per-layer metrics read.

A record set (:func:`reduce`) holds the stretch's wall, the CUDA kernels
(name, start, end), every device operation (kernels, copies and fills),
the host's operations and the benchmark's own spans, all in seconds on
one clock.  :func:`busy_seconds` takes the union of the device operations'
intervals, not a sum of their times, so overlapping streams count once;
:func:`breakdown` lists the device operations that took most time and the
idle gaps by what the host was doing when each began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN = "bench.stretch"
NAME_CHARS = 160    # a kernel's name is cut to this in the breakdown


def _events(prof):
    """``(kind, name, start_s, end_s)`` of every profiled event: kind
    ``"kernel"``, ``"device"`` (copies, fills), ``"span"`` (a user
    annotation on the host) or ``"host"``."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        t0 = ev.start_ns() * 1e-9
        t1 = t0 + ev.duration_ns() * 1e-9
        user = getattr(ev, "is_user_annotation", lambda: False)()
        act = str(getattr(ev, "activity_type", lambda: "")()).lower()
        if ev.device_type() == DeviceType.CPU:
            out.append(("span" if user or name.startswith("bench.") else "host",
                        name, t0, t1))
        elif user or "annotation" in act or name.startswith("bench."):
            continue
        elif "memcpy" in act or "memset" in act or name.startswith(
                ("Memcpy", "Memset")):
            out.append(("device", name, t0, t1))
        else:
            out.append(("kernel", name, t0, t1))
    return out


def profile(body):
    """Run ``body()`` under the profiler inside a ``bench.stretch`` span
    that ends after a synchronise -> ``(body's result, records)``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        with record_function(SPAN):
            result = body()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return result, reduce(_events(prof))


def reduce(events) -> dict:
    """Records of one stretch from ``(kind, name, start_s, end_s)`` events:
    the stretch is the ``bench.stretch`` span."""
    spans = [e for e in events if e[0] == "span"]
    outer = [e for e in spans if e[1] == SPAN]
    lo, hi = ((outer[0][2], outer[0][3]) if outer else
              (min(e[2] for e in events), max(e[3] for e in events)))
    inside = [e for e in events if e[3] > lo and e[2] < hi]
    return {"stretch": (lo, hi), "stretch_s": hi - lo,
            "kernels": [e[1:] for e in inside if e[0] == "kernel"],
            "device": [e[1:] for e in inside if e[0] in ("kernel", "device")],
            "host": [e[1:] for e in inside if e[0] in ("host", "span")]}


def _union(intervals, lo, hi):
    """Merged ``(start, end)`` intervals clipped to [lo, hi]."""
    merged = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(rec) -> float:
    """Seconds of the stretch in which some operation ran on the device."""
    lo, hi = rec["stretch"]
    return sum(e - s for s, e in _union(rec["device"], lo, hi))


def idle_gaps(rec):
    """``[(start, end)]`` of the stretch's intervals with no device
    operation."""
    lo, hi = rec["stretch"]
    gaps, t = [], lo
    for s, e in _union(rec["device"], lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _host_at(host, starts, spans, t):
    """What the host was doing at time ``t``: the innermost host operation
    open then (the latest-begun among the last few thousand begun before
    ``t``), else the innermost benchmark span, else None."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host[max(0, i - 2000):i]):
        if e >= t:
            return name
    open_spans = [sp for sp in spans if sp[1] <= t <= sp[2]]
    return max(open_spans, key=lambda sp: sp[1])[0] if open_spans else None


def breakdown(rec, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by the
    host operation open when each idle gap began, each ``[[name,
    seconds]]`` with at most ``top`` entries."""
    by_op = defaultdict(float)
    for name, s, e in rec["device"]:
        by_op[name] += e - s
    host = sorted(rec["host"], key=lambda x: x[1])
    starts = [h[1] for h in host]
    spans = [h for h in host if h[0].startswith("bench.")]
    by_host = defaultdict(float)
    for s, e in idle_gaps(rec):
        by_host[_host_at(host, starts, spans, s) or "host idle"] += e - s
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
