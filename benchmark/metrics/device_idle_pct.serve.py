"""The share (%) of the traced stretch's wall in which no operation ran on
the device (the union of their intervals, not a sum of their times), in
the serve cells.  Layer: Device."""

from benchmark.core.trace import busy_seconds


def read(rec):
    if rec["stretch_s"] <= 0 or not rec["device"]:
        return None
    return 100.0 * (1.0 - busy_seconds(rec) / rec["stretch_s"])
