"""The port's ``utils.profiling`` and ``utils.logging``: a
``torch.profiler`` trace that names an ``annotate`` span (a Chrome trace
JSON where the JAX package writes xprof: a stated divergence), and
``get_logger``'s name, level variable and single handler.  The spans and
counters themselves are ``test_torch_tracing.py``'s."""

import glob
import json
import logging

import torch

from embracenet_tpu_torch.utils import logging as tlog
from embracenet_tpu_torch.utils import profiling as tprof


def test_device_trace_writes_a_trace_that_names_the_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.device_trace(log_dir) as prof:
        with tprof.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(f"{log_dir}/*.pt.trace.json")
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
    assert any(e.key == "my_region" for e in prof.key_averages())


def test_get_logger_names_levels_and_adds_one_handler(monkeypatch):
    root = logging.getLogger("embracenet_tpu_torch")
    monkeypatch.setattr(root, "handlers", [])
    monkeypatch.setattr(root, "level", root.level)
    monkeypatch.setattr(root, "propagate", root.propagate)
    monkeypatch.setenv("EMBRACENET_LOG", "debug")
    log = tlog.get_logger("embracenet_tpu_torch.sweep")
    assert log.name == "embracenet_tpu_torch.sweep"
    assert log.parent is root and log.getEffectiveLevel() == logging.DEBUG
    assert len(root.handlers) == 1 and not root.propagate
    assert tlog.get_logger() is root
    monkeypatch.setenv("EMBRACENET_LOG", "error")
    tlog.get_logger("embracenet_tpu_torch.cli")
    assert len(root.handlers) == 1 and root.level == logging.DEBUG
