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
(0-d for one trial, ``[T]`` stacked over a population).  A population
updates as one program, as the JAX update runs vmapped: params leaves
``[T, ...]`` and ``opt_id`` / ``lr`` / ``weight_decay`` ``[T]``, broadcast
over each leaf's trailing axes, with a ``[T]`` ``upd`` mask that keeps a
frozen trial's params and state as they were.

On the card the update of every leaf of every trial is one launch of a
hand-written kernel (``csrc/optim_update.cu``, :func:`fused_update`),
built at first use with ``nvcc`` for ``sm_90a`` into
``embracenet_tpu_torch/_build/`` (``ops/embrace.build``) and loaded with
``ctypes``; its launches are the ``optim.launches`` counter.  It equals
the plain version (:func:`apply_update_reference`, the CPU's path) bit for
bit, and writes its new leaves as views of fresh buffers, out of place.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from embracenet_tpu_torch.convert import tree_leaves, tree_map, tree_unflatten
from embracenet_tpu_torch.ops import embrace
from embracenet_tpu_torch.utils.profiling import count

ADAM, NADAM, RMSPROP = 0, 1, 2
OPTIMIZER_IDS = {"Adam": ADAM, "Nadam": NADAM, "RMSprop": RMSPROP}

_B1, _B2 = 0.9, 0.999
_RMS_ALPHA = 0.99
_EPS = 1e-8
_SCHED_DECAY = 4e-3

SOURCE = Path(embrace.SOURCE).with_name("optim_update.cu")
ALIGN = 256        # elements: a leaf's start in the fused update's buffers
CHUNK = 8192       # elements of one trial of one leaf a block takes at a time
MAX_LEAVES = 64    # leaves the kernel's arguments hold
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def init_state(params, state_dtype=None, master: bool = False, lead=()):
    """Optimizer state: per-leaf (m, v) zeros, ``step`` 0 and
    ``m_schedule`` 1 of shape ``lead`` on the params' device; with
    ``master`` a float32 copy of ``params``."""
    dev = tree_leaves(params)[0].device
    state = {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype), params),
        "step": torch.zeros(lead, device=dev),
        "m_schedule": torch.ones(lead, device=dev),
    }
    if master:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def apply_update(params, grads, state, opt_id, lr, weight_decay, upd=None):
    """One optimizer step -> ``(new_params, new_state)``.  ``grads`` has the
    params' structure (a None leaf counts as a zero gradient); ``opt_id``,
    ``lr`` and ``weight_decay`` are numbers or 0-d tensors (tensors on the
    state's device keep a step on the card free of host copies), or for a
    population stacked over a leading trial axis ``[T]`` tensors, as are
    ``state["step"]`` and ``state["m_schedule"]``.  ``upd`` (a bool tensor
    of their shape, optional): where False, the trial's params and state
    come back unchanged (a stopped trial, a batch of padding).  On the CPU
    the plain version (:func:`apply_update_reference`) runs; on the card
    one launch of the kernel (:func:`fused_update`) updates every leaf of
    every trial, bit for bit as the plain version does, into new tensors:
    the inputs are left as they were."""
    dev = state["step"].device
    if dev.type != "cuda":
        return apply_update_reference(params, grads, state, opt_id, lr,
                                      weight_decay, upd)
    step = state["step"] + 1.0
    opt_id = torch.as_tensor(opt_id, device=dev)
    beta2 = torch.where(opt_id == RMSPROP, _RMS_ALPHA, _B2)
    # the plain version's four powers, taken as it takes them; the kernel
    # derives the rest of each trial's coefficients from them
    trials = {"opt_id": opt_id, "lr": lr, "weight_decay": weight_decay,
              "step": step, "step0": state["step"],
              "m_schedule": state["m_schedule"],
              "pow_t": 0.96 ** (step * _SCHED_DECAY),
              "pow_t1": 0.96 ** ((step + 1.0) * _SCHED_DECAY),
              "pow_b1": _B1 ** step, "pow_b2": beta2 ** step}
    leaves_w = tree_leaves(state["master"]) if "master" in state else None
    new_p, new_m, new_v, new_w, new_step, new_ms = fused_update(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]), leaves_w, trials, upd)
    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v),
                 "step": new_step, "m_schedule": new_ms}
    if new_w is not None:
        new_state["master"] = tree_unflatten(params, new_w)
    return tree_unflatten(params, new_p), new_state


def apply_update_reference(params, grads, state, opt_id, lr, weight_decay,
                           upd=None):
    """The plain version of :func:`apply_update`, its arithmetic as PyTorch
    operations on any device: the CPU's path and the kernel's yardstick."""
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

    # every leaf's update in one pass over the leaves laid end to end
    # ([*lead, N]; lead = the trial axis of a population), so a step costs
    # a few kernels rather than a few per leaf; the per-trial scalars
    # broadcast over N, and each element's arithmetic is the per-leaf one
    lead = tuple(state["step"].shape)
    leaves_p = tree_leaves(params)
    leaves_m, leaves_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    leaves_w = tree_leaves(state["master"]) if "master" in state else None
    sizes = [p.numel() // max(1, math.prod(lead)) for p in leaves_p]

    def flat(leaves):
        return torch.cat([t.reshape(lead + (-1,)) for t in leaves], dim=-1)

    def col(x):
        return x.reshape(x.shape + (1,))

    # w is the float32 master (absent when params are the source of truth);
    # every cast is a no-op on the plain float32 path
    p32 = flat([t.float() for t in (leaves_w or leaves_p)])
    g = flat([torch.zeros_like(p, dtype=torch.float32) if t is None
              else t.float() for t, p in zip(tree_leaves(grads), leaves_p)])
    m_old, v_old = flat(leaves_m), flat(leaves_v)
    g = g + col(weight_decay) * p32
    m_new = _B1 * m_old.float() + (1.0 - _B1) * g
    v_new = col(beta2) * v_old.float() + (1.0 - col(beta2)) * g * g
    denom = torch.sqrt(v_new * col(vscale)) + _EPS
    delta = (col(cg) * g + col(cm) * m_new) / denom
    new_w = p32 - col(lr) * delta
    m_new, v_new = m_new.to(m_old.dtype), v_new.to(v_old.dtype)
    if upd is not None:
        keep = col(upd)
        new_w = torch.where(keep, new_w, p32)
        m_new = torch.where(keep, m_new, m_old)
        v_new = torch.where(keep, v_new, v_old)

    def leaves_of(flat_t, like):
        return [piece.reshape(t.shape) for piece, t in
                zip(flat_t.split(sizes, dim=-1), like)]

    new_state = {"m": tree_unflatten(params, leaves_of(m_new, leaves_m)),
                 "v": tree_unflatten(params, leaves_of(v_new, leaves_v)),
                 "step": step if upd is None else torch.where(
                     upd, step, state["step"]),
                 "m_schedule": m_sched_new if upd is None else torch.where(
                     upd, m_sched_new, state["m_schedule"])}
    if leaves_w is not None:
        new_state["master"] = tree_unflatten(params, leaves_of(new_w, leaves_w))
    # params come back contiguous, as the kernels read them
    return tree_unflatten(params, [w.to(p.dtype).contiguous() for w, p in
                                   zip(leaves_of(new_w, leaves_p), leaves_p)]), \
        new_state


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(embrace.build(SOURCE).path))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        # table, n_leaves, n_chunks, trials, T, p_out, m_out, v_out, w_out,
        # p_dtype, s_dtype, stream
        lib.optim_update.argtypes = [p, i32, i32, p, i32] + [p] * 4 + [
            i32] * 2 + [p]
        lib.optim_update.restype = i32
        _lib = lib
    return _lib


def leaf_offsets(sizes):
    """Each leaf's first element in :func:`fused_update`'s output buffers
    (``sizes``: a leaf's elements, every trial's), a multiple of ``ALIGN``,
    and the buffers' length."""
    padded = np.asarray([-(-int(n) // ALIGN) * ALIGN for n in sizes], np.int64)
    return np.cumsum(padded) - padded, int(padded.sum())


def leaf_views(buf, like) -> list:
    """The leaves laid out in ``buf`` by :func:`leaf_offsets`: contiguous
    views with the shapes of the leaves ``like``."""
    sizes = [t.numel() for t in like]
    offsets, total = leaf_offsets(sizes)
    gaps = np.diff(offsets, append=total) - sizes
    # one split into every leaf and the gap after it
    pieces = buf.split_with_sizes([int(k) for pair in zip(sizes, gaps)
                                   for k in pair])
    return [piece.view(t.shape) for piece, t in zip(pieces[::2], like)]


def first_chunks(per_trial, n_trials):
    """Each leaf's first chunk in a launch over these leaves (``per_trial``:
    a leaf's elements a trial) and the launch's chunks.  A chunk is at most
    ``CHUNK`` elements of one trial of one leaf: leaf l's ``k_l =
    ceil(n_l / CHUNK)`` chunks a trial follow each other trial by trial,
    so its chunk ``first_l + t k_l + j`` holds trial t's elements from ``j
    CHUNK`` on (``csrc/optim_update.cu`` finds them so)."""
    k = np.asarray([-(-int(n) // CHUNK) * n_trials for n in per_trial],
                   np.int64)
    return np.cumsum(k) - k, int(k.sum())


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check(lead, leaves_p, leaves_g, leaves_m, leaves_v, leaves_w):
    """Raises on leaves the kernel does not take; returns the dtypes of
    the params (and their gradients) and of the state."""
    dev = leaves_p[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused_update: the kernel runs on a CUDA device, "
                         f"got {dev}")
    p_dt, s_dt = leaves_p[0].dtype, leaves_m[0].dtype
    for kind, leaves, dt in (("params", leaves_p, p_dt),
                             ("grads", leaves_g, p_dt),
                             ("m", leaves_m, s_dt), ("v", leaves_v, s_dt),
                             ("master", leaves_w or [], torch.float32)):
        for i, t in enumerate(leaves):
            if t is None:   # a gradient the kernel reads as zero
                continue
            if t.dtype != dt or dt not in _DTYPE_CODE:
                raise ValueError(f"fused_update: {kind} leaf {i} is {t.dtype};"
                                 f" the kernel takes params and gradients all "
                                 f"float32 or all bfloat16, m and v alike, "
                                 f"the master float32")
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"fused_update: {kind} leaf {i} must be "
                                 f"contiguous on {dev}")
    for i, p in enumerate(leaves_p):
        like = [leaves_m[i], leaves_v[i], leaves_g[i]] + (
            [leaves_w[i]] if leaves_w else [])
        if tuple(p.shape[:len(lead)]) != lead or any(
                t is not None and t.shape != p.shape for t in like):
            raise ValueError(f"fused_update: leaf {i} has shape "
                             f"{tuple(p.shape)}, its gradient or state "
                             f"another, or no leading {lead}")
    return p_dt, s_dt


# the per-trial tensors the kernel reads, in its order (csrc/optim_update.cu)
TRIAL_KEYS = ("opt_id", "lr", "weight_decay", "step", "step0", "m_schedule",
              "pow_t", "pow_t1", "pow_b1", "pow_b2")


def fused_update(leaves_p, leaves_g, leaves_m, leaves_v, leaves_w, trials,
                 upd):
    """Every leaf's update by ``csrc/optim_update.cu`` -> ``(params, m, v,
    master or None, step, m_schedule)``: the new leaves, each a contiguous
    view of one fresh buffer a kind (leaf-major, each leaf's start a
    multiple of ``ALIGN`` elements), and the new per-trial state.  One
    launch on the current stream, not waited for; the launches are the
    ``optim.launches`` counter.  Up to ``MAX_LEAVES`` leaves (every model
    family has fewer), each ``[*lead, ...]`` (``lead``: the shape of
    ``trials["step"]``), contiguous, on one CUDA device: params float32 or
    bf16 (their gradients alike), m and v float32 or bf16, the master
    float32.  ``trials`` holds
    :data:`TRIAL_KEYS`, each broadcast to ``lead``: the optimizer id, lr and
    weight decay, the new and the old step, the old momentum schedule and
    the plain version's four powers at the new step; ``upd`` as
    :func:`apply_update` takes it."""
    lead = tuple(trials["step"].shape)
    p_dt, s_dt = _check(lead, leaves_p, leaves_g, leaves_m, leaves_v,
                        leaves_w)
    dev, n_trials = leaves_p[0].device, math.prod(lead)
    vecs = [torch.broadcast_to(torch.as_tensor(
        trials[k], dtype=torch.int32 if k == "opt_id" else torch.float32,
        device=dev), lead).contiguous() for k in TRIAL_KEYS]
    keep = None if upd is None else torch.broadcast_to(
        torch.as_tensor(upd, dtype=torch.bool, device=dev), lead).contiguous()
    new_step = torch.empty(lead, device=dev)
    new_ms = torch.empty(lead, device=dev)
    sizes = [p.numel() for p in leaves_p]
    leaves = [i for i, n in enumerate(sizes) if n]
    per_trial = [sizes[i] // n_trials for i in leaves]
    if len(leaves) > MAX_LEAVES or max(per_trial) > 2**31 - 1 - CHUNK:
        raise ValueError(f"fused_update: the kernel takes up to {MAX_LEAVES} "
                         f"leaves of under 2**31 elements a trial, got "
                         f"{len(leaves)} leaves of up to {max(per_trial)}")
    offsets, total = leaf_offsets(sizes)
    out_p = torch.empty(total, dtype=p_dt, device=dev)
    out_m = torch.empty(total, dtype=s_dt, device=dev)
    out_v = torch.empty(total, dtype=s_dt, device=dev)
    out_w = torch.empty(total, device=dev) if leaves_w else None
    first, n_chunks = first_chunks(per_trial, n_trials)
    # a row a leaf: p, g, m, v, master, start in the outputs, elements a
    # trial, first chunk
    table = np.asarray(
        [[_ptr(leaves_p[i]), _ptr(leaves_g[i]), _ptr(leaves_m[i]),
          _ptr(leaves_v[i]), _ptr(leaves_w[i]) if leaves_w else 0,
          offsets[i], n, f] for i, n, f in zip(leaves, per_trial, first)],
        np.int64)
    ptrs = np.asarray([v.data_ptr() for v in vecs] + [
        _ptr(keep), new_step.data_ptr(), new_ms.data_ptr()], np.int64)
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.optim_update(
            table.ctypes.data, len(leaves), n_chunks, ptrs.ctypes.data,
            n_trials, out_p.data_ptr(), out_m.data_ptr(), out_v.data_ptr(),
            _ptr(out_w), _DTYPE_CODE[p_dt], _DTYPE_CODE[s_dt],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"optim_update: CUDA launch failed with error "
                           f"{err} ({torch.cuda.get_device_name(dev)})")
    count("optim.launches")
    return (leaf_views(out_p, leaves_p), leaf_views(out_m, leaves_p),
            leaf_views(out_v, leaves_p),
            None if out_w is None else leaf_views(out_w, leaves_p),
            new_step, new_ms)
