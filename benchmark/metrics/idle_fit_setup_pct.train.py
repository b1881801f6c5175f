"""The share (%) of the traced stretch's wall in which the device was idle
while the program's ``engine.fit.setup`` span was open: a fit's host
init of its population, the stack and the copies to the device, before
its first step.  Layer: Engine."""

from benchmark.core.spans import idle_pct


def read(rec):
    return idle_pct(rec, "engine.fit.setup")
