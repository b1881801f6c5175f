"""The fused docking + embracement forward's share of its roofline (%),
in the train cells.  Layer: Kernel (``ops/embrace.py`` ->
``csrc/embrace.cu``)."""

from benchmark.core.roofline import share

PREFIX = "embrace_fused_fwd"    # both entries: the tiled and the full-E kernel


def read(rec):
    return share(rec, PREFIX)
