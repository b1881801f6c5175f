"""Launches of the per-trial random draws a stacked train step: the
program's traced ``draws.launches`` counter (every ``torch.rand`` /
``randint``, stack, fill and copy ``models/layers.Draws`` issues) over its
traced ``engine.train_steps``.  Layer: Engine."""

from benchmark.core.spans import program_counters


def read(rec):
    counts = program_counters()
    steps = counts.get("engine.train_steps")
    if not steps or "draws.launches" not in counts:
        return None
    return counts["draws.launches"] / steps
