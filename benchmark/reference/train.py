"""The reference's side of a training cell: a fit's first steps, trial by
trial, in plain PyTorch.

For each group of the population it works out again what the port's
``engine.fit`` derives from the seed and the data: each trial's init and
run seeds (``frozen.seeds``), its initial parameters
(``multimodal.init_trial``), the balanced batch plan (``frozen.plans``),
each step's draws (``multimodal.StepDraws``), and it takes the steps: the
trial's forward, the INS-weighted cross entropy, autograd's gradients and
the optimizer update below.  It reports per trial each step's loss, each
live leaf's first gradient as the optimizer takes it (weight decay
added), its raw gradient, and its change over the steps taken.

The update is the one the port's ``ops/optim.py`` documents: coupled
weight decay; Adam (0.9, 0.999, eps 1e-8, both moments bias-corrected),
RMSprop (alpha 0.99, no momentum) and timm's legacy Nadam (schedule decay
4e-3) as one formula, ``delta = (cg g + cm m) / (sqrt(v vscale) + eps)``.
"""

from __future__ import annotations

import torch

from benchmark.frozen.seeds import group_seed, seed_streams, step_seeds
from benchmark.reference import multimodal as M
from benchmark.reference.precision import exact

_B1, _B2, _RMS, _EPS, _DECAY = 0.9, 0.999, 0.99, 1e-8, 4e-3
ADAM, NADAM, RMSPROP = 0, 1, 2


def update(P, G, state, a: dict):
    """One optimizer step of the trial's live leaves, in place of ``P``
    (float32); ``state`` holds ``m``, ``v``, ``step``, ``m_schedule``."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    step = state["step"] + 1.0
    kind = a["optimizer"]
    beta2 = f32(_RMS if kind == RMSPROP else _B2)
    mu_t = _B1 * (1.0 - 0.5 * f32(0.96) ** (step * _DECAY))
    mu_t1 = _B1 * (1.0 - 0.5 * f32(0.96) ** ((step + 1.0) * _DECAY))
    sched = state["m_schedule"] * mu_t
    sched_next = sched * mu_t1
    bc1, bc2 = 1.0 - _B1 ** step, 1.0 - beta2 ** step
    if kind == ADAM:
        cg, cm, vscale = f32(0.0), 1.0 / bc1, 1.0 / bc2
    elif kind == NADAM:
        cg, cm, vscale = (1.0 - mu_t) / (1.0 - sched), \
            mu_t1 / (1.0 - sched_next), 1.0 / bc2
    else:
        cg, cm, vscale = f32(1.0), f32(0.0), f32(1.0)
    lr, wd = f32(a["lr"]), f32(a["weight_decay"])
    dev = next(iter(P.values())).device
    cg, cm, vscale, beta2, lr, wd = (t.to(dev) for t in
                                     (cg, cm, vscale, beta2, lr, wd))
    decayed = {}
    for k, p in P.items():
        g = G[k] + wd * p
        decayed[k] = g
        m = _B1 * state["m"][k] + (1.0 - _B1) * g
        v = beta2 * state["v"][k] + (1.0 - beta2) * g * g
        denom = torch.sqrt(v * vscale) + _EPS
        P[k] = p - lr * ((cg * g + cm * m) / denom)
        state["m"][k], state["v"][k] = m, v
    state["step"], state["m_schedule"] = step, sched
    return decayed


def follow_trial(a: dict, init_seed: int, run_seed: int, data: dict,
                 plan, in_features: int, width_buckets: bool,
                 precision: str, steps: int, device, cpu_draw=False,
                 fault: str | None = None) -> dict:
    """``steps`` training steps of one trial on the rows of the plan's
    first batches -> ``{"loss": [steps], "grad": {leaf: norm}, "raw":
    {leaf: norm}, "change": {leaf: norm}}``: ``grad`` the first step's
    gradient with weight decay added, ``raw`` autograd's, ``change`` the
    norm of each leaf's move over the steps.  ``fault`` plants a fault in
    the reference put in the program's place: ``"half"`` takes each step
    over the first half of its rows only, ``"unchanged"`` skips every
    update, ``"lr"`` takes the steps at 1.1 times the trial's learning
    rate."""
    idx, mask = plan
    if fault == "lr":
        a = dict(a, lr=a["lr"] * 1.1)
    P0 = {k: v.to(device) for k, v in M.init_trial(a, init_seed,
                                                    in_features).items()}
    P = dict(P0)
    state = {"m": {k: torch.zeros_like(v) for k, v in P.items()},
             "v": {k: torch.zeros_like(v) for k, v in P.items()},
             "step": torch.zeros(()), "m_schedule": torch.ones(())}
    out = {"loss": []}
    for s, seed in enumerate(step_seeds(run_seed, steps)):
        rows = torch.as_tensor(idx[s], device=device)
        m = torch.as_tensor(mask[s], device=device)
        if fault == "half":
            m = m.clone()
            m[m.shape[0] // 2:] = 0.0
        draws = M.StepDraws(a, seed, rows.shape[0], width_buckets, device)
        live = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        with exact():
            logits = M.forward(a, live, data["ffnn"][rows], data["cnn"][rows],
                               m, precision, draws, cpu_draw=cpu_draw)
            loss = M.weighted_cross_entropy(logits, data["y"][rows], m)
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
        G = {k: (torch.zeros_like(v) if g is None else g.detach())
             for (k, v), g in zip(live.items(), grads)}
        out["loss"].append(float(loss.detach()))
        P = {k: v.detach() for k, v in live.items()}
        if fault == "unchanged":
            decayed = {k: torch.zeros_like(v) for k, v in P.items()}
        else:
            decayed = update(P, G, state, a)
        if s == 0:
            out["grad"] = {k: float(g.norm()) for k, g in decayed.items()}
            out["raw"] = {k: float(g.norm()) for k, g in G.items()}
    out["change"] = {k: float((P[k] - P0[k]).norm()) for k in P}
    return out


def follow(archs_by_group: list, seed: int, data: dict, plan,
           in_features: int, width_buckets: bool, precision: str,
           steps: int, device, cpu_draw=False, fault=None) -> list:
    """:func:`follow_trial` for every trial of every group, each with the
    seeds its group's fit gives it -> one list per group.  The fault
    ``"lr"`` is planted in one trial only, the first group's last."""
    out = []
    for g, archs in enumerate(archs_by_group):
        init, run = seed_streams(group_seed(seed, g), len(archs))
        out.append([follow_trial(a, init[t], run[t], data, plan, in_features,
                                 width_buckets, precision, steps, device,
                                 cpu_draw, fault if fault != "lr" or
                                 (g, t) == (0, len(archs) - 1) else None)
                    for t, a in enumerate(archs)])
    return out
