"""The numbers that decide ``correct``, each against a limit.

Training (per trial of every group, against the reference's same trial):

* ``loss_gap``: the largest relative gap of the first step's loss;
* ``grad_gap``: over live leaves, the largest gap between the norms of the
  first gradient as the optimizer takes it (weight decay added), over the
  larger of the reference's norm of that leaf and of the trial's median
  leaf;
* ``step_gap``: the largest over the trials of each trial's median, over
  its live leaves, of the same gap of each leaf's change over the steps
  taken, leaving out leaves whose raw reference gradient is under a
  thousandth of its trial's median leaf's (a convolution's bias under
  BatchNorm: nought but round-off, which Adam turns into lr-sized moves).
  A median per trial, so that a fault in one trial's update (its
  optimizer's formula, its learning rate, its freeze-select) shows, not
  only one in every trial's.

The later steps' losses and the worst leaf's change are reported beside
them (``loss_gap_steps``, ``step_gap_leaf``) but not compared: a trial at
a large learning rate turns round-off into lr-sized moves of the elements
whose gradient is near nought, so both swing from seed to seed in the
program as in a sound reference (``PERF.md`` gives the readings).

Serving: ``prob_gap``, the largest absolute gap of a class probability
over the sampled answers.
"""

from __future__ import annotations

import statistics

EXCLUDE_BELOW = 1e-3


def _leaf_gaps(port: dict, ref: dict, keep) -> dict:
    """Each kept leaf's ``|port - ref| / max(ref, median(ref))``."""
    med = statistics.median(ref.values())
    return {k: abs(port[k] - r) / max(r, med, 1e-30)
            for k, r in ref.items() if k in keep}


def train_gaps(port: list, ref: list) -> dict:
    """``port`` and ``ref``: per group, per trial ``{"loss", "grad",
    "change"}`` (``ref`` also ``"raw"``) -> ``{name: (value, where)}``."""
    worst = {k: (0.0, None) for k in ("loss_gap", "grad_gap", "step_gap",
                                      "loss_gap_steps", "step_gap_leaf")}

    def note(name, value, where):
        if value > worst[name][0]:
            worst[name] = (value, where)

    for g, (pg, rg) in enumerate(zip(port, ref)):
        for t, (p, r) in enumerate(zip(pg, rg)):
            at = f"group {g} trial {t}"
            for s, (lp, lr) in enumerate(zip(p["loss"], r["loss"])):
                gap = abs(lp - lr) / max(abs(lr), 1e-30)
                note("loss_gap_steps", gap, f"{at} step {s + 1}")
                if s == 0:
                    note("loss_gap", gap, at)
            gaps = _leaf_gaps(p["grad"], r["grad"], r["grad"])
            leaf = max(gaps, key=gaps.get)
            note("grad_gap", gaps[leaf], f"{at} {leaf}")
            med = statistics.median(r["raw"].values())
            keep = {k for k, v in r["raw"].items() if v >= EXCLUDE_BELOW * med}
            gaps = _leaf_gaps(p["change"], r["change"], keep)
            leaf = max(gaps, key=gaps.get)
            note("step_gap_leaf", gaps[leaf], f"{at} {leaf}")
            note("step_gap", statistics.median(gaps.values()),
                 f"{at} median leaf")
    return worst


def verdict(values: dict, limits: dict) -> tuple:
    """``values`` ``{name: value}`` against ``limits`` -> ``(correct,
    {name: {"value", "limit"}})``; a number that is not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = float(values[name])
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v == v and v <= limit
    return ok, checks
