"""Uniform init/apply adapters over the model families (port of
``embracenet_tpu/training/modelspec.py``).

``apply`` takes ``seed`` (an int that seeds the forward's random draws) in
place of the JAX package's PRNG key, and ``init_from_fans`` a
``torch.Generator`` in place of ``init_traced``'s key; everything else keeps
the JAX calling convention.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from embracenet_tpu_torch.data import codec
from embracenet_tpu_torch.models import cnn, embracenet, ffnn
from embracenet_tpu_torch.models.layers import as_dtype

MODEL_FAMILIES = ("FFNN", "CNN", "CNN_LSTM", "EmbraceNetMultimodal",
                  "ConcatNetMultimodal")

#: families this package does not port yet
_NOT_PORTED = ("ConcatNetMultimodal", "CNN_LSTM")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    inputs: tuple          # subset of ("ffnn", "cnn")
    init: Callable         # (generator, hp_concrete) -> (params, bn_state)
    apply: Callable        # (params, bn_state, hp, inputs, train, seed,
    #                         row_mask, compute_dtype, statics) -> (logits, bn)
    statics: Callable = None   # hp_list -> dict of static shape knobs
    fan_ins: Callable = None   # hp_concrete -> fan-in tree (numpy)
    init_from_fans: Callable = None  # (generator, fans) -> (params, bn_state):
    #                                  a population inits trial by trial from
    #                                  per-trial generators (engine.fit)


def _cnn_statics(hp_list, key="cnn"):
    """Depth + width + kernel bucket for the CNN branch: the population's
    deepest trial, and per layer the widest channel / kernel any trial
    that uses the layer selects (unused layers get the smallest menu
    entry so the key is draw-stable)."""
    from embracenet_tpu_torch.config import (CNN_CHANNEL_MENUS,
                                             CNN_KERNEL_MENU, CNN_MAX_LAYERS)

    subs = [hp[key] if key else hp for hp in hp_list]
    depth = max(int(s["n_layers"]) for s in subs)
    mc, mk = [], []
    for i in range(CNN_MAX_LAYERS):
        used = [int(s["channels"][i]) for s in subs if int(s["n_layers"]) > i]
        mc.append(max(used) if used else min(CNN_CHANNEL_MENUS[i]))
        used_k = [int(s["kernels"][i]) for s in subs if int(s["n_layers"]) > i]
        mk.append(max(used_k) if used_k else min(CNN_KERNEL_MENU))
    return {"cnn_max_depth": depth, "cnn_max_channels": tuple(mc),
            "cnn_max_kernels": tuple(mk)}


def _ffnn_width(hp_list, key="ffnn"):
    """Max live width over trials (layers beyond a trial's depth ignored)."""
    w = 0
    for hp in hp_list:
        sub = hp[key] if key else hp
        n = int(sub["n_layers"])
        w = max(w, max(int(x) for x in np.asarray(sub["widths"])[:n]))
    return w


def _post_width(hp_list, key, min_width=16):
    w = min_width
    for hp in hp_list:
        n = int(hp["n_post"])
        if n > 0:
            w = max(w, max(int(x) for x in np.asarray(hp[key])[:n]))
    return w


def _seq_input(inputs, compute_dtype):
    """codes uint8 [B, 256] -> one-hot [B, 4, 256] on the codes' device."""
    return codec.one_hot(inputs["cnn"], dtype=as_dtype(compute_dtype) or torch.float32)


@functools.lru_cache(maxsize=None)
def get_spec(model: str, in_features_ffnn: int | None = None) -> ModelSpec:
    """Memoized: repeated calls return the identical ModelSpec object."""
    return _build_spec(model, in_features_ffnn)


def _build_spec(model: str, in_features_ffnn: int | None = None) -> ModelSpec:
    if model == "FFNN":
        def init(generator, hp):
            return ffnn.init(generator, hp, in_features_ffnn), {}

        def apply(params, bn_state, hp, inputs, train, seed, row_mask,
                  compute_dtype, statics=None):
            gen = torch.Generator(inputs["ffnn"].device).manual_seed(int(seed))
            logits = ffnn.apply(params, hp, inputs["ffnn"], train=train,
                                generator=gen, compute_dtype=compute_dtype,
                                max_width=(statics or {}).get("ffnn_max_width"))
            return logits, bn_state

        return ModelSpec(model, ("ffnn",), init, apply,
                         lambda hps: {"ffnn_max_width": _ffnn_width(hps, key=None)},
                         fan_ins=lambda hp: ffnn.fan_ins(hp, in_features_ffnn),
                         init_from_fans=lambda gen, fans: (
                             ffnn.init_from_fans(gen, fans, in_features_ffnn), {}))

    if model == "CNN":
        def apply(params, bn_state, hp, inputs, train, seed, row_mask,
                  compute_dtype, statics=None):
            x = _seq_input(inputs, compute_dtype)
            gen = torch.Generator(x.device).manual_seed(int(seed))
            st = statics or {}
            return cnn.apply(params, bn_state, hp, x, train=train, generator=gen,
                             row_mask=row_mask, compute_dtype=compute_dtype,
                             max_depth=st.get("cnn_max_depth"),
                             max_channels=st.get("cnn_max_channels"),
                             max_kernels=st.get("cnn_max_kernels"))

        return ModelSpec(model, ("cnn",), cnn.init, apply,
                         lambda hps: _cnn_statics(hps, key=None),
                         fan_ins=cnn.fan_ins, init_from_fans=cnn.init_from_fans)

    if model == "EmbraceNetMultimodal":
        def init(generator, hp):
            return embracenet.init(generator, hp, in_features_ffnn)

        def apply(params, bn_state, hp, inputs, train, seed, row_mask,
                  compute_dtype, statics=None):
            x = _seq_input(inputs, compute_dtype)
            st = statics or {}
            return embracenet.apply(params, bn_state, hp, inputs["ffnn"], x,
                                    train=train, seed=seed, row_mask=row_mask,
                                    compute_dtype=compute_dtype,
                                    cnn_max_depth=st.get("cnn_max_depth"),
                                    cnn_max_channels=st.get("cnn_max_channels"),
                                    cnn_max_kernels=st.get("cnn_max_kernels"),
                                    ffnn_max_width=st.get("ffnn_max_width"),
                                    embrace_max=st.get("embrace_max"),
                                    post_max=st.get("post_max"),
                                    fused=st.get("fused_embrace", False))

        def statics(hps):
            out = _cnn_statics(hps)
            out["ffnn_max_width"] = _ffnn_width(hps)
            out["embrace_max"] = max(int(hp["embrace_size"]) for hp in hps)
            out["post_max"] = _post_width(hps, "post_widths")
            return out

        return ModelSpec(model, ("ffnn", "cnn"), init, apply, statics,
                         fan_ins=lambda hp: embracenet.fan_ins(hp, in_features_ffnn),
                         init_from_fans=lambda gen, fans: embracenet.init_from_fans(
                             gen, fans, in_features_ffnn))

    if model in _NOT_PORTED:
        raise NotImplementedError(f"{model} is not ported to PyTorch yet: "
                                  f"ROADMAP.md Queue 1, 'Remaining models'")
    raise ValueError(f"unknown model family: {model} (use one of {MODEL_FAMILIES})")
