"""The readers of the program's spans and counters (``core/spans.py`` and
the metrics built on it) on synthetic records: idle time inside spans that
overlap, gaps that cross a span's edge, a program without spans or
counters."""

from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core import spans
from benchmark.run import load_module
from embracenet_tpu_torch.utils import profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"
IDLE = {"idle_fit_setup_pct.train": "engine.fit.setup",
        "idle_step_pct.train": "engine.step",
        "idle_eval_pct.train": "engine.eval",
        "idle_copy_in_pct.serve": "reload.copy_in"}


def reader(name):
    return load_module(METRICS / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def record(host, device=(("k", 1.0, 2.0), ("k", 4.0, 6.0))):
    """A 10 s stretch whose device runs [1, 2] and [4, 6]: idle [0, 1],
    [2, 4] and [6, 10]."""
    return {"stretch": (0.0, 10.0), "stretch_s": 10.0,
            "kernels": list(device), "device": list(device),
            "host": list(host)}


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_idle_in_a_span_is_its_share_of_the_idle_gaps():
    rec = record([("engine.fit.setup", 0.0, 3.0), ("aten::add", 0.5, 0.6)])
    # [0, 1] and [2, 3]: the gap [2, 4] crosses the span's end
    assert spans.idle_in(rec, "engine.fit.setup") == pytest.approx(2.0)
    assert spans.idle_pct(rec, "engine.fit.setup") == pytest.approx(20.0)


def test_overlapping_spans_count_their_union_once():
    rec = record([("engine.step", 3.5, 5.0), ("engine.step", 4.5, 7.0),
                  ("engine.step", 6.5, 6.8)])
    # union [3.5, 7]: idle [3.5, 4] and [6, 7]
    assert spans.idle_in(rec, "engine.step") == pytest.approx(1.5)


def test_a_span_past_the_stretch_is_clipped_to_it():
    rec = record([("engine.eval", 8.0, 12.0), ("engine.eval", -3.0, 0.5)])
    assert spans.idle_in(rec, "engine.eval") == pytest.approx(2.5)


def test_a_span_over_busy_time_only_reads_zero():
    rec = record([("reload.copy_in", 4.2, 5.8)])
    assert spans.idle_pct(rec, "reload.copy_in") == 0.0


@pytest.mark.parametrize("name", sorted(IDLE))
def test_idle_readers(name):
    span = IDLE[name]
    rec = record([(span, 0.0, 3.0), (span, 2.5, 4.5), ("other", 6.0, 10.0)])
    # union [0, 4.5]: idle [0, 1] and [2, 4]
    assert reader(name)(rec) == pytest.approx(30.0)
    assert reader(name)(record([("other", 0.0, 10.0)])) is None
    assert reader(name)(record([(span, 0.0, 3.0)], device=())) is None


def _traced(counts):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counts.items():
            profiling.count(name, n)


def test_counter_readers_read_the_traced_counts():
    profiling.count("engine.train_steps", 99)      # outside the profile
    _traced({"engine.train_steps": 71, "draws.launches": 71 * 150,
             "engine.to_device_bytes": 409_500_000,
             "reload.rows_real": 60_000, "reload.rows_run": 73_728})
    rec = record([])
    assert reader("draw_launches_per_train_step")(rec) == 150.0
    assert reader("fit_to_device_mb.train")(rec) == 409.5
    assert reader("pad_rows_pct.serve")(rec) == pytest.approx(
        100.0 * 2_288 / 12_288)


def test_counter_readers_find_nothing_without_counts():
    profiling.count("draws.launches", 5)            # never traced
    rec = record([])
    for name in ("draw_launches_per_train_step", "fit_to_device_mb.train",
                 "pad_rows_pct.serve"):
        assert reader(name)(rec) is None


def test_a_program_without_counters_reads_none(monkeypatch):
    """A program older than its counters: the readers report nothing and
    raise nothing."""
    _traced({"engine.train_steps": 3, "draws.launches": 30})
    monkeypatch.delattr(profiling, "counters")
    assert spans.program_counters() == {}
    assert reader("draw_launches_per_train_step")(record([])) is None


def test_program_spans_reach_the_records_as_spans():
    from benchmark.core import trace

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("engine.fit.setup"):
            torch.ones(4) + 1
    events = trace._events(prof)
    assert ("span", "engine.fit.setup") in {e[:2] for e in events}
    rec = trace.reduce(events)
    assert spans.span_intervals(rec, "engine.fit.setup")
