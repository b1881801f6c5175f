"""Megabytes (1e6 bytes) the traced population pass copied from the host
to the device inside ``engine.fit`` (params, BatchNorm state, the split,
plans and hyperparameters; one fit a group): the program's traced
``engine.to_device_bytes`` counter.  Layer: Engine."""

from benchmark.core.spans import program_counters


def read(rec):
    moved = program_counters().get("engine.to_device_bytes")
    return None if not moved else moved / 1e6
