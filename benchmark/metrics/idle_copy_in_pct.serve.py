"""The share (%) of the traced stretch's wall in which the device was idle
while one of the program's ``reload.copy_in`` spans was open (a request's
host arrays padded to whole micro-batches and copied to the device).
Layer: Reload."""

from benchmark.core.spans import idle_pct


def read(rec):
    return idle_pct(rec, "reload.copy_in")
