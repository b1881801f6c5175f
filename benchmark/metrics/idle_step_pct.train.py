"""The share (%) of the traced stretch's wall in which the device was idle
while one of the program's ``engine.step`` spans was open (a stacked
train step: its gather, draws, forward, backward and update).  Layer:
Engine."""

from benchmark.core.spans import idle_pct


def read(rec):
    return idle_pct(rec, "engine.step")
