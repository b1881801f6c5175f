"""Population training of a family whose shapes follow each trial's
architecture (CNN_LSTM): an HPO study's population, trained as the port's
``hpo/search.run_search`` trains it when its spec is not vmappable.

``run_search`` then groups the trials by ``spec.statics`` (their
architecture), in the order each signature first appears, and fits group
g with ``engine.fit`` at the seed ``seed + 7919 g``
(``frozen.seeds.group_seed``); trials of distinct architectures are fits
of one.  This driver forms the same groups and seeds.  Set-up draws the
cell's data from the seed and warms each group's shapes with one short
fit (a few train and evaluation batches, padded to the window's batch
rows).  The window repeats whole population passes, every group's fit
one after another, as a study does; the first pass is watched by
:class:`Capture` (each fit's first stacked step).  After the window the
reference (``reference/cnn_lstm.py``) takes the same step of every trial
at its own widths, and the gaps decide ``correct``.

The same interface as ``drivers/population.py``: ``setup``, ``window``,
``stretch``, ``check``, and for ``calibrate.py`` ``Capture``, ``STEPS``,
``_fit``, ``_port_side`` and ``reference``.  A fit, a pass and the traced
stretch (its stacked train steps summed over the fits; no fused kernel
launches) are that driver's, imported.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core.checks import train_gaps
from benchmark.drivers import population as P
from benchmark.drivers.population import _B1, _fit, _population_pass, stretch
from benchmark.frozen import cnn_lstm as A
from benchmark.frozen.data import make_data
from benchmark.frozen.flops import PEAK_FLOPS
from benchmark.frozen.plans import balanced_plan
from benchmark.reference import cnn_lstm as R


#: the stacked steps of each fit the reference follows: one.  Later steps
#: of the large-lr trials are ill-conditioned on the card: trial 0 (RMSprop
#: at lr 0.045) saturates after its first step, and its next two turn the
#: round-off of cuDNN's LSTM (about 5 times a float32 loop's in a step's
#: gradients) into a three-step ``step_gap`` of 1.0e-2, the program's and
#: the reference's own with only its recurrence on cuDNN alike, where the
#: loop reads 9.6e-5 from float64 and the TF32 control 5.75e-4 and up
#: (PERF.md §4).  The later steps, the optimizer's moments among them, are
#: held at the cell's widths on the CPU
#: (``tests/test_torch_cnn_lstm_reference.py``).
STEPS = 1


class Capture(P.Capture):
    """``drivers/population.Capture`` keeping a fit's first :data:`STEPS`
    steps: their losses, the parameters before them, the optimizer's
    first moment after the first, the parameters after the last."""

    def __call__(self, *args, **kwargs):
        out = self.step_fn(*args, **kwargs)
        rec = self.fits[-1]
        if len(rec["loss"]) < STEPS:
            if not rec["loss"]:
                rec["params0"], rec["m1"] = args[1], out[4]["m"]
            rec["loss"].append(out[0])
            if len(rec["loss"]) == STEPS:
                rec["params"] = out[2]
        return out


def groups_of(spec, hps: list) -> list:
    """``run_search``'s groups of a population that is not vmappable:
    trial indices by ``spec.statics`` signature, in first-appearance
    order."""
    by_sig: dict = {}
    for i, hp in enumerate(hps):
        by_sig.setdefault(tuple(sorted(spec.statics([hp]).items())),
                          []).append(i)
    return list(by_sig.values())


def setup(ctx) -> dict:
    import torch

    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.hpo import space
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.modelspec import get_spec

    cfg, mix = ctx["config"], ctx["traffic"]
    model, flats = cfg["model"], cfg["population"]
    hps = [space.params_to_hp(model, f) for f in flats]
    spec = get_spec(model)
    n_tr, n_va = cfg["hpo_train_windows"], cfg["hpo_val_windows"]
    data = make_data(n_tr + n_va, cfg["in_features"],
                     np.random.default_rng(ctx["seed"]), mix["prevalence"])
    train = {k: data[k][:n_tr] for k in ("cnn", "y")}
    val = {k: data[k][n_tr:] for k in ("cnn", "y")}
    bs, epochs = mix["batch_size"], cfg["num_epochs"]
    tcfg = TrainConfig(num_epochs=epochs, batch_size=bs,
                       compute_dtype=mix["compute_dtype"],
                       patience=epochs + 1)
    plan = balanced_plan(train["y"], bs)
    st = {"engine": engine, "spec": spec, "tcfg": tcfg,
          "groups": groups_of(spec, hps), "hps": hps,
          "opts": [space.optimizer_hp(f) for f in flats],
          "archs": [A.arch(f) for f in flats], "train": train, "val": val,
          "plan": plan}
    # one short fit a group: its shapes at the window's batch rows
    w = mix["warmup_windows"]
    short_tr = {k: v[:w] for k, v in train.items()}
    short_va = {k: v[:w] for k, v in val.items()}
    for g in range(len(st["groups"])):
        _fit(ctx, st, g, short_tr, short_va, plan_rows=(plan[0].shape[1], 2 * bs))
    if ctx["device"] == "cuda":
        torch.cuda.synchronize()
    return st


def window(ctx, st, seconds: float) -> dict:
    import torch

    engine = st["engine"]
    st["capture"] = Capture(engine.population_step)
    engine.population_step, st["watching"] = st["capture"], True
    passes = failed = 0
    pass_s = []
    t0 = time.perf_counter()
    try:
        while True:
            t = time.perf_counter()
            failed += not _population_pass(ctx, st)
            pass_s.append(time.perf_counter() - t)
            if passes == 0:
                engine.population_step = st["capture"].step_fn
                st["watching"] = False
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if ctx["device"] == "cuda":
            torch.cuda.synchronize()
    finally:
        engine.population_step = st["capture"].step_fn
    wall = time.perf_counter() - t0
    cfg = ctx["config"]
    useful = passes * sum(
        A.train_flops(a, cfg["hpo_train_windows"], cfg["hpo_val_windows"],
                      cfg["num_epochs"]) for a in st["archs"])
    windows = float(st["plan"][1].sum()) * len(st["hps"])
    return {"attempted": passes, "failed": failed, "wall_s": wall,
            "metrics": {"train_windows_per_s": passes * windows / wall},
            "useful_flops": useful,
            "peak_flops": PEAK_FLOPS[ctx["traffic"]["compute_dtype"]],
            "detail": {"pass_s": pass_s}}


def _port_side(st) -> list:
    """Per group, per trial: the watched steps' losses, each leaf's first
    gradient (from the optimizer's first moment) and its change."""
    out = []
    for g, idxs in enumerate(st["groups"]):
        rec = st["capture"].fits[g]
        loss = np.stack([t.float().cpu().numpy() for t in rec["loss"]])
        trials = []
        for t, i in enumerate(idxs):
            grad, change = {}, {}
            for name, path, _, _ in A.leaves(st["archs"][i]):
                def leaf(tree, path=path):
                    for p in path:
                        tree = tree[p]
                    return tree[t].float()
                grad[name] = float((leaf(rec["m1"]) / (1.0 - _B1)).norm())
                change[name] = float((leaf(rec["params"])
                                      - leaf(rec["params0"])).norm())
            trials.append({"loss": loss[:, t].tolist(), "grad": grad,
                           "change": change})
        out.append(trials)
    return out


def reference(ctx, st, precision: str, fault=None) -> list:
    """The reference's side of the watched steps at ``precision``."""
    import torch

    dev = ctx["device"]
    data = {k: torch.as_tensor(st["train"][k], device=dev)
            for k in ("cnn", "y")}
    idx, mask = st["plan"]
    return R.follow([[st["archs"][i] for i in g] for g in st["groups"]],
                    ctx["seed"], data, (idx[:STEPS], mask[:STEPS]),
                    precision, STEPS, dev, fault=fault)


def check(ctx, st, win) -> dict:
    """The port's side, then the program's state freed, then the reference
    -> ``{name: value}`` and where each worst gap lies."""
    import torch

    port = _port_side(st)
    del st["capture"]
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, st, ctx["traffic"]["compute_dtype"])
    gaps = train_gaps(port, ref)
    return {k: v[0] for k, v in gaps.items()}, {k: v[1] for k, v in gaps.items()}
