"""The share (%) of the rows the traced requests computed that were
padding: 100 x (``reload.rows_run`` - ``reload.rows_real``) /
``reload.rows_run``, the program's traced counters.  Layer: Reload."""

from benchmark.core.spans import program_counters


def read(rec):
    counts = program_counters()
    run, real = counts.get("reload.rows_run"), counts.get("reload.rows_real")
    if not run or real is None:
        return None
    return 100.0 * (run - real) / run
