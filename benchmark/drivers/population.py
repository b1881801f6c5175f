"""Population training: an HPO study's population, trained as the port's
``hpo/search.run_search`` trains it.

Set-up draws the cell's data from the seed, splits the configuration's
population into the groups ``plan_buckets`` forms (one group without width
buckets), and warms each group's shapes with one short fit (a few train
and evaluation batches, padded to the window's batch rows).  The window
repeats whole population passes, each one ``engine.fit`` per group, one
after another, as a study does; the first pass is watched: for every
group the first stacked steps' losses, the parameters before them, the
optimizer's first moment after the first and the parameters after the
last are kept (references only, nothing is copied or waited for).  After
the window the reference follows the same steps of every trial, and the
gaps decide ``correct``.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.frozen import arch as A
from benchmark.frozen.data import make_data
from benchmark.frozen.flops import PEAK_FLOPS, train_flops
from benchmark.frozen.plans import balanced_plan, eval_batches
from benchmark.frozen.seeds import group_seed
from benchmark.reference import multimodal as M
from benchmark.reference.train import follow

STEPS = 3          # the stacked steps of each fit the reference follows
_B1 = 0.9          # Adam's first-moment decay: m after one step = 0.1 g


class Capture:
    """Stands in for ``engine.population_step`` during the first pass and
    keeps what the first :data:`STEPS` steps of each fit produced."""

    def __init__(self, step_fn):
        self.step_fn, self.fits = step_fn, []

    def begin(self):
        self.fits.append({"loss": []})

    def __call__(self, *args, **kwargs):
        out = self.step_fn(*args, **kwargs)
        rec = self.fits[-1]
        k = len(rec["loss"])
        if k < STEPS:
            if k == 0:
                rec["params0"], rec["m1"] = args[1], out[4]["m"]
            rec["loss"].append(out[0])
            if k == STEPS - 1:
                rec["params"] = out[2]
        return out


def setup(ctx) -> dict:
    import torch

    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.hpo import space
    from embracenet_tpu_torch.training import engine
    from embracenet_tpu_torch.training.bucketing import plan_buckets
    from embracenet_tpu_torch.training.modelspec import get_spec

    cfg, mix = ctx["config"], ctx["traffic"]
    model, F = cfg["model"], cfg["in_features"]
    flats = cfg["population"]
    hps = [space.params_to_hp(model, f) for f in flats]
    spec = get_spec(model, in_features_ffnn=F)
    wb = bool(mix["width_buckets"])
    groups = (plan_buckets(spec, model, hps) if wb and len(hps) > 1
              else [list(range(len(hps)))])
    n_tr, n_va = cfg["hpo_train_windows"], cfg["hpo_val_windows"]
    data = make_data(n_tr + n_va, F, np.random.default_rng(ctx["seed"]),
                     mix["prevalence"])
    train = {k: v[:n_tr] for k, v in data.items()}
    val = {k: v[n_tr:] for k, v in data.items()}
    bs, epochs = mix["batch_size"], cfg["num_epochs"]
    tcfg = TrainConfig(num_epochs=epochs, batch_size=bs,
                       compute_dtype=mix["compute_dtype"],
                       patience=epochs + 1, width_buckets=wb,
                       pipeline_chunks=bool(mix["pipeline_chunks"]))
    plan = balanced_plan(train["y"], bs)
    st = {"engine": engine, "spec": spec, "tcfg": tcfg, "groups": groups,
          "hps": hps, "opts": [space.optimizer_hp(f) for f in flats],
          "archs": [A.arch(model, f) for f in flats], "train": train,
          "val": val, "plan": plan, "wb": wb}
    # one short fit a group: its shapes at the window's batch rows
    w = mix["warmup_windows"]
    short_tr = {k: v[:w] for k, v in train.items()}
    short_va = {k: v[:w] for k, v in val.items()}
    for g in range(len(groups)):
        _fit(ctx, st, g, short_tr, short_va, plan_rows=(plan[0].shape[1], 2 * bs))
    if ctx["device"] == "cuda":
        torch.cuda.synchronize()
    return st


def _fit(ctx, st, g, train, val, plan_rows=(0, 0)):
    idxs = st["groups"][g]
    return st["engine"].fit(st["spec"], [st["hps"][i] for i in idxs],
                            [st["opts"][i] for i in idxs], train, val,
                            st["tcfg"], seed=group_seed(ctx["seed"], g),
                            device=ctx["device"], plan_rows=plan_rows)


def _population_pass(ctx, st, spans=False) -> bool:
    """Every group's fit, one after another -> whether every trial's train
    losses are finite."""
    import torch

    ok = True
    for g in range(len(st["groups"])):
        if st.get("watching"):
            st["capture"].begin()
        if spans:
            with torch.profiler.record_function(f"bench.fit.group{g}"):
                res = _fit(ctx, st, g, st["train"], st["val"])
        else:
            res = _fit(ctx, st, g, st["train"], st["val"])
        ok = ok and all(math.isfinite(v) for h in res.loss_train for v in h)
    return ok


def _windows_per_pass(st) -> float:
    return float(st["plan"][1].sum()) * len(st["hps"])


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
    cfg, dtype = ctx["config"], ctx["traffic"]["compute_dtype"]
    useful = passes * sum(
        train_flops(a, cfg["in_features"], cfg["hpo_train_windows"],
                    cfg["hpo_val_windows"], cfg["num_epochs"])
        for a in st["archs"])
    return {"attempted": passes, "failed": failed, "wall_s": wall,
            "metrics": {"train_windows_per_s":
                        passes * _windows_per_pass(st) / wall},
            "useful_flops": useful, "peak_flops": PEAK_FLOPS[dtype],
            "detail": {"pass_s": pass_s}}


def stretch(ctx, st) -> dict:
    """One more population pass under the profiler -> what it computed:
    its stacked train steps and its fused-kernel launches by shape."""
    import torch

    with torch.profiler.record_function("bench.pass"):
        _population_pass(ctx, st, spans=True)
    cfg, mix = ctx["config"], ctx["traffic"]
    epochs, n_tr_b = cfg["num_epochs"], st["plan"][0].shape[0]
    n_ev_b = eval_batches(cfg["hpo_val_windows"], 2 * mix["batch_size"])
    launches = []
    if cfg["model"] == A.EMBRACENET:
        for idxs in st["groups"]:
            bk = A.buckets([st["archs"][i] for i in idxs], st["wb"])
            for n, rows in ((n_tr_b, st["plan"][0].shape[1]),
                            (n_ev_b, 2 * mix["batch_size"])):
                launches.append((epochs * n, len(idxs), rows, bk["W"], bk["D1"],
                                 bk["EB"], mix["compute_dtype"]))
    return {"train_steps": epochs * n_tr_b * len(st["groups"]),
            "launches": launches}


def _port_side(st) -> list:
    """Per group, per trial: the watched steps' losses, each live leaf's
    first gradient (from the optimizer's first moment) and its change."""
    out = []
    for g, idxs in enumerate(st["groups"]):
        rec = st["capture"].fits[g]
        archs = [st["archs"][i] for i in idxs]
        bk = A.buckets(archs, st["wb"])
        loss = np.stack([t.float().cpu().numpy() for t in rec["loss"]])
        trials = []
        for t, a in enumerate(archs):
            grad, change = {}, {}
            for name, (path, idx) in M.live_blocks(a, bk).items():
                leaf = lambda tree: M.take(M.get_path(tree, path)[t].float(),  # noqa: E731
                                           idx)
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
    data = {"ffnn": torch.as_tensor(st["train"]["ffnn"], device=dev),
            "cnn": torch.as_tensor(st["train"]["cnn"], device=dev),
            "y": torch.as_tensor(st["train"]["y"], device=dev)}
    idx, mask = st["plan"]
    return follow([[st["archs"][i] for i in g] for g in st["groups"]],
                  ctx["seed"], data, (idx[:STEPS], mask[:STEPS]),
                  ctx["config"]["in_features"], st["wb"], precision, STEPS,
                  dev, cpu_draw=dev == "cpu", fault=fault)


def check(ctx, st, win) -> dict:
    """The port's side, then the program's state freed, then the reference
    -> ``{name: value}`` and where each worst gap lies."""
    import torch

    from benchmark.core.checks import train_gaps

    port = _port_side(st)
    del st["capture"]
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, st, ctx["traffic"]["compute_dtype"])
    gaps = train_gaps(port, ref)
    return {k: v[0] for k, v in gaps.items()}, {k: v[1] for k, v in gaps.items()}
