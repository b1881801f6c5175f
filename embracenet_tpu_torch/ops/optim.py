"""Torch-parity optimizers (Adam, Nadam, RMSprop) as one branchless update
(port of ``embracenet_tpu/ops/optim.py``).

The reference samples the optimizer kind per trial
(`BIOINF_tesi/models/utils/training_models.py:269-276`: torch Adam, torch
RMSprop, timm Nadam).  All three share the state ``(m, v, step,
m_schedule)`` and the update ``delta = (cg * g + cm * m_new) / denom`` with
``denom = sqrt(v_new * vscale) + eps``; ``opt_id`` selects the three
scalars, so a population mixes optimizers without a branch per kind.  The
formula is the JAX package's, not ``torch.optim``'s (which places eps
differently for Adam's bias correction).

  * weight decay is coupled (added to the gradient), torch-style;
  * Adam: betas (0.9, 0.999), eps 1e-8, bias correction on both moments;
  * RMSprop: alpha 0.99, eps 1e-8, no momentum, not centered;
  * Nadam: timm's legacy Nadam with schedule_decay 4e-3.

``state_dtype=bfloat16`` stores m and v in bf16; ``master=True`` keeps an
float32 copy of the params in ``state["master"]`` as the source of truth
while the live params are bf16.  The update math is float32 either way.

State trees are nested dicts of tensors with the params' structure.
``step`` and ``m_schedule`` are tensors of the shape the caller gives
(0-d for one trial, ``[T]`` stacked over a population).
"""

from __future__ import annotations

import torch

from embracenet_tpu_torch.convert import tree_map

ADAM, NADAM, RMSPROP = 0, 1, 2
OPTIMIZER_IDS = {"Adam": ADAM, "Nadam": NADAM, "RMSprop": RMSPROP}

_B1, _B2 = 0.9, 0.999
_RMS_ALPHA = 0.99
_EPS = 1e-8
_SCHED_DECAY = 4e-3


def init_state(params, state_dtype=None, master: bool = False, lead=()):
    """Optimizer state: per-leaf (m, v) zeros, ``step`` 0 and
    ``m_schedule`` 1 of shape ``lead`` on the params' device; with
    ``master`` a float32 copy of ``params``."""
    leaves = []
    tree_map(leaves.append, params)
    dev = leaves[0].device
    state = {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype), params),
        "step": torch.zeros(lead, device=dev),
        "m_schedule": torch.ones(lead, device=dev),
    }
    if master:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def apply_update(params, grads, state, opt_id, lr, weight_decay):
    """One optimizer step -> ``(new_params, new_state)``.  ``grads`` has the
    params' structure (a None leaf counts as a zero gradient); ``opt_id``,
    ``lr`` and ``weight_decay`` are numbers or 0-d tensors (tensors on the
    state's device keep a step on the card free of host copies)."""
    dev = state["step"].device
    step = state["step"] + 1.0
    opt_id = torch.as_tensor(opt_id, device=dev)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    weight_decay = torch.as_tensor(weight_decay, dtype=torch.float32, device=dev)
    is_rms, is_nadam = opt_id == RMSPROP, opt_id == NADAM

    beta2 = torch.where(is_rms, _RMS_ALPHA, _B2)
    # Nadam momentum schedule (timm legacy Nadam)
    mu_t = _B1 * (1.0 - 0.5 * 0.96 ** (step * _SCHED_DECAY))
    mu_t1 = _B1 * (1.0 - 0.5 * 0.96 ** ((step + 1.0) * _SCHED_DECAY))
    m_sched_new = state["m_schedule"] * mu_t
    m_sched_next = m_sched_new * mu_t1
    bc1 = 1.0 - _B1 ** step
    bc2 = 1.0 - beta2 ** step

    #   Adam:    cg = 0,                    cm = 1/bc1,              vscale = 1/bc2
    #   Nadam:   cg = (1-mu_t)/(1-msched),  cm = mu_t1/(1-msched'),  vscale = 1/bc2
    #   RMSprop: cg = 1,                    cm = 0,                  vscale = 1
    nadam_cg = (1.0 - mu_t) / (1.0 - m_sched_new)
    nadam_cm = mu_t1 / (1.0 - m_sched_next)
    cg = torch.where(is_rms, 1.0, torch.where(is_nadam, nadam_cg, 0.0))
    cm = torch.where(is_rms, 0.0, torch.where(is_nadam, nadam_cm, 1.0 / bc1))
    vscale = torch.where(is_rms, 1.0, 1.0 / bc2)

    def leaf_update(p, g, m, v, w=None):
        # w is the float32 master (None when params are the source of
        # truth); every cast is a no-op on the plain float32 path
        p32 = (p if w is None else w).float()
        g = (torch.zeros_like(p32) if g is None else g.float()) + weight_decay * p32
        m_new = _B1 * m.float() + (1.0 - _B1) * g
        v_new = beta2 * v.float() + (1.0 - beta2) * g * g
        denom = torch.sqrt(v_new * vscale) + _EPS
        delta = (cg * g + cm * m_new) / denom
        new_w = p32 - lr * delta
        return new_w.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype), new_w

    masters = [state["master"]] if "master" in state else []
    out = tree_map(leaf_update, params, grads, state["m"], state["v"], *masters)
    new_state = {"m": tree_map(lambda o: o[1], out),
                 "v": tree_map(lambda o: o[2], out),
                 "step": step, "m_schedule": m_sched_new}
    if masters:
        new_state["master"] = tree_map(lambda o: o[3], out)
    return tree_map(lambda o: o[0], out), new_state
