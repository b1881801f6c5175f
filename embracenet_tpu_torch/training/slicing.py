"""Shrink/grow parameter trees to width-bucket shapes (port of
``embracenet_tpu/training/slicing.py``).

Width bucketing slices *compute* (models/*.py apply statics), but if the
parameters stay full-shape the optimizer still reads/writes the full
supernet every batch (grads arrive as pad-scattered full arrays and Adam
moments live at full width), so memory traffic stays at the monolithic
level even though the matmuls shrank.  Shrinking the parameter pytree itself to
the bucket dims before ``optim.init_state`` cuts that traffic to the bucket
size; the model ``apply`` functions are written as ``a[:c]`` slices, which
are no-ops on already-shrunk leaves, so the SAME model code serves
both layouts.

``grow`` pads the trained bucket back to full supernet shapes at the end of
``fit`` so checkpoints, ``weight_reset`` and reload keep one stable layout.
Padding is zeros except BatchNorm ``scale``/``var`` (ones); padded regions
are dead by construction (no trial's mask reaches them).

All functions accept stacked ([T, ...]) or unstacked trees: slices/pads
address the TRAILING dims only.
"""

from __future__ import annotations

import torch

from embracenet_tpu_torch.config import (
    CNN_IN_CHANNELS,
    CNN_MAX_CHANNELS,
    CNN_MAX_LAYERS,
    EMBRACE_MAX_POST_LAYERS,
    EMBRACE_MAX_SIZE,
    FFNN_MAX_LAYERS,
    FFNN_MAX_WIDTH,
)
from embracenet_tpu_torch.models.cnn import FLAT_MAX, flat_bucket

WIDTH_KEYS = ("cnn_max_channels", "ffnn_max_width", "embrace_max", "post_max")

_E = EMBRACE_MAX_SIZE      # 1024
_EMB_P = 512               # embracenet post space (models/embracenet.py P)
_CAT_P = 1024              # concatnet post space (models/concatnet.py P)


def has_width_statics(statics: dict) -> bool:
    return any(k in statics for k in WIDTH_KEYS)


def _slc(a, dims):
    """Slice the trailing len(dims) dims to the given sizes (None = keep)."""
    idx = (Ellipsis,) + tuple(slice(0, d) if d is not None else slice(None)
                              for d in dims)
    return a[idx]


def _pad(a, dims, fill=0.0):
    """Pad the trailing len(dims) dims up to the given sizes (None = keep)."""
    nlead = a.ndim - len(dims)
    shape = tuple(a.shape[:nlead]) + tuple(
        d if d is not None else a.shape[nlead + i] for i, d in enumerate(dims))
    if shape == tuple(a.shape):
        return a
    out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


_BN_FILLS = {"scale": 1.0, "var": 1.0}


def _map(tree, dims_tree, op):
    out = dict(tree)
    for k, dims in dims_tree.items():
        if k not in tree:
            continue
        if isinstance(dims, dict):
            out[k] = _map(tree[k], dims, op)
        else:
            out[k] = op(tree[k], dims, _BN_FILLS.get(k, 0.0))
    return out


def _ffnn_dims(W, head: bool):
    d = {}
    for i in range(FFNN_MAX_LAYERS):
        d[f"w{i}"] = (None, W) if i == 0 else (W, W)
        d[f"b{i}"] = (W,)
    if head:
        d["w_head"] = (W, None)
    return d


def _cnn_dims(mc, fb, head: bool):
    d = {}
    for i in range(CNN_MAX_LAYERS):
        c_in = CNN_IN_CHANNELS if i == 0 else mc[i - 1]
        d[f"conv_w{i}"] = (mc[i], c_in, None)
        d[f"conv_b{i}"] = (mc[i],)
        d[f"bn{i}"] = {"scale": (mc[i],), "bias": (mc[i],)}
    if head:
        d["w_fc1"] = (fb, None)
    return d


def _bn_state_dims(mc):
    return {f"bn{i}": {"mean": (mc[i],), "var": (mc[i],)}
            for i in range(CNN_MAX_LAYERS)}


def _bucket(statics: dict):
    mc = tuple(statics.get("cnn_max_channels", CNN_MAX_CHANNELS))
    fb = flat_bucket(CNN_MAX_LAYERS, mc)
    W = statics.get("ffnn_max_width", FFNN_MAX_WIDTH)
    return mc, fb, W


def _generic_dims(model: str, statics: dict):
    mc, fb, W = _bucket(statics)
    if model == "FFNN":
        return _ffnn_dims(W, head=True), {}
    if model == "CNN":
        return _cnn_dims(mc, fb, head=True), _bn_state_dims(mc)
    if model == "EmbraceNetMultimodal":
        EB = statics.get("embrace_max", _E)
        PB = statics.get("post_max", _EMB_P)
        d = {"ffnn": _ffnn_dims(W, head=False),
             "cnn": _cnn_dims(mc, fb, head=False),
             "dock0_w": (W, EB), "dock0_b": (EB,),
             "dock1_w": (fb, EB), "dock1_b": (EB,)}
        for i in range(EMBRACE_MAX_POST_LAYERS):
            d[f"post_w{i}"] = (EB, PB) if i == 0 else (PB, PB)
            d[f"post_b{i}"] = (PB,)
        return d, _bn_state_dims(mc)
    if model == "ConcatNetMultimodal":
        PB = statics.get("post_max", _CAT_P)
        d = {"ffnn": _ffnn_dims(W, head=False),
             "cnn": _cnn_dims(mc, fb, head=False),
             "head_w": (PB, None),
             "post_w1": (PB, PB), "post_w2": (PB, PB)}
        for i in range(3):
            d[f"post_b{i}"] = (PB,)
        return d, _bn_state_dims(mc)
    return {}, {}


def shrink(model: str, params, bn_state, statics: dict):
    """Slice a full-shape (params, bn_state) pair down to bucket shapes."""
    d, bn_d = _generic_dims(model, statics)
    p = _map(params, d, lambda a, dims, f: _slc(a, dims))
    b = _map(bn_state, bn_d, lambda a, dims, f: _slc(a, dims))
    mc, fb, W = _bucket(statics)
    if model == "EmbraceNetMultimodal" and "head_w" in p:
        EB = statics.get("embrace_max", _E)
        PB = statics.get("post_max", _EMB_P)
        a = p["head_w"]  # full rows: [E | P]
        p["head_w"] = torch.cat(
            [a[..., :EB, :], a[..., _E:_E + PB, :]], dim=-2)
    if model == "ConcatNetMultimodal" and "post_w0" in p:
        PB = statics.get("post_max", _CAT_P)
        a = p["post_w0"]  # full rows: [FFNN_MAX_WIDTH | FLAT_MAX]
        rows = torch.cat(
            [a[..., :W, :],
             a[..., FFNN_MAX_WIDTH:FFNN_MAX_WIDTH + fb, :]], dim=-2)
        p["post_w0"] = _slc(rows, (None, PB))
    return p, b


def grow(model: str, params, bn_state, statics: dict):
    """Pad bucket-shaped (params, bn_state) back to full supernet shapes."""
    mc, fb, W = _bucket(statics)
    p = dict(params)
    if model == "EmbraceNetMultimodal" and "head_w" in p:
        EB = statics.get("embrace_max", _E)
        PB = statics.get("post_max", _EMB_P)
        a = p["head_w"]  # bucket rows: [EB | PB]
        p["head_w"] = torch.cat(
            [_pad(a[..., :EB, :], (_E, None)),
             _pad(a[..., EB:EB + PB, :], (_EMB_P, None))], dim=-2)
    if model == "ConcatNetMultimodal" and "post_w0" in p:
        a = _pad(p["post_w0"], (None, _CAT_P))  # bucket rows: [W | fb]
        p["post_w0"] = torch.cat(
            [_pad(a[..., :W, :], (FFNN_MAX_WIDTH, None)),
             _pad(a[..., W:W + fb, :], (FLAT_MAX, None))], dim=-2)
    full_d, full_bn = _generic_dims(model, {})
    p = _map(p, full_d, lambda a, dims, f: _pad(a, dims, f))
    b = _map(bn_state, full_bn, lambda a, dims, f: _pad(a, dims, f))
    return p, b
