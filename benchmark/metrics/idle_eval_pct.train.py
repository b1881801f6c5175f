"""The share (%) of the traced stretch's wall in which the device was idle
while one of the program's ``engine.eval`` spans was open (an epoch's
evaluation batches).  Layer: Engine."""

from benchmark.core.spans import idle_pct


def read(rec):
    return idle_pct(rec, "engine.eval")
