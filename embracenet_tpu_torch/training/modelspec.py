"""Uniform init/apply adapters over the model families (port of
``embracenet_tpu/training/modelspec.py``).

``init`` takes a ``torch.Generator`` (or a ``layers.InitPlan``) and
``apply`` a ``seed`` (an int that seeds the forward's random draws) in
place of the JAX package's PRNG keys; everything else keeps the JAX
calling convention.  ``apply_trials`` is what ``jax.vmap(spec.apply)`` is
in the JAX engine: a population's stacked params, BN state and
hyperparameters (:func:`stack_hps`, in a ``layers.Trials``) in one forward
pass, each trial drawing from its own generator (``layers.Draws``).  Each
family writes only ``apply_trials``; its one-trial ``apply`` is that of a
population of one (:func:`_one_trial_apply`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from embracenet_tpu_torch.data import codec
from embracenet_tpu_torch.models import cnn, cnn_lstm, concatnet, embracenet, ffnn
from embracenet_tpu_torch.models.layers import as_dtype, one_trial
# stack_hps, the JAX engine's ``stack_trials(hp_list)``, is exported here
# beside the specs whose ``apply_trials`` reads what it stacks
from embracenet_tpu_torch.models.layers import stack_hps  # noqa: F401

MODEL_FAMILIES = ("FFNN", "CNN", "CNN_LSTM", "EmbraceNetMultimodal",
                  "ConcatNetMultimodal")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    inputs: tuple          # subset of ("ffnn", "cnn")
    init: Callable         # (generator, hp_concrete) -> (params, bn_state)
    apply: Callable        # (params, bn_state, hp, inputs, train, seed,
    #                         row_mask, compute_dtype, statics, shard)
    #                         -> (logits, bn); shard: a BatchShard or None
    statics: Callable = None   # hp_list -> dict of static shape knobs
    vmappable: bool = True     # False: shapes vary per trial; HPO fits
    #                            each architecture as its own population
    fan_ins: Callable = None   # hp_concrete -> fan-in tree (numpy)
    apply_trials: Callable = None  # (params, bn_state, trials, inputs, train,
    #                                row_mask, compute_dtype, statics, shard,
    #                                seed) -> (logits [T, B, 2], bn): the
    #                                population's forward; ``trials`` a
    #                                layers.Trials, params / bn leaves and
    #                                row_mask [T, ...], inputs [T, B, ...] or
    #                                [B, ...] (shared by every trial), seed
    #                                the fused kernel's eval key


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


def _seq_trials(inputs, n_trials, compute_dtype):
    """codes uint8 [B, 256] (shared) or [T, B, 256] -> the CNN's one-hot
    layout of a population, [B, T*4, 256], on the codes' device."""
    x = codec.one_hot(inputs["cnn"],
                      dtype=as_dtype(compute_dtype) or torch.float32)
    return cnn.trial_channels(x, n_trials)


def _ffnn_trials(inputs, n_trials):
    """features [B, F] (shared) or [T, B, F] -> [T, B, F]."""
    x = inputs["ffnn"]
    return x.expand(n_trials, *x.shape).contiguous() if x.dim() == 2 else x


def _one_trial_apply(apply_trials, key: str):
    """``ModelSpec.apply`` from a family's ``apply_trials``: one trial as a
    population of one (``layers.one_trial``), its draws from a
    ``torch.Generator`` seeded with ``seed`` on the inputs' device, which
    in eval mode also keys the fused kernel; ``key`` names an input whose
    rows are the batch's."""
    def apply(params, bn_state, hp, inputs, train, seed, row_mask,
              compute_dtype, statics=None, shard=None):
        x = inputs[key]
        trials, stack, unstack = one_trial(hp, x.shape[0], x.device, seed,
                                           train, shard)
        logits, bn = apply_trials(stack(params), stack(bn_state), trials,
                                  inputs, train, stack(row_mask),
                                  compute_dtype, statics, shard, seed)
        return logits[0], unstack(bn)
    return apply


def _spec(name, inputs, init, statics, apply_trials, **kw) -> ModelSpec:
    """A family's spec, its one-trial ``apply`` derived from its
    ``apply_trials``."""
    return ModelSpec(name, inputs, init,
                     _one_trial_apply(apply_trials, inputs[0]), statics,
                     apply_trials=apply_trials, **kw)


@functools.lru_cache(maxsize=None)
def get_spec(model: str, in_features_ffnn: int | None = None) -> ModelSpec:
    """Memoized: repeated calls return the identical ModelSpec object."""
    return _build_spec(model, in_features_ffnn)


def _build_spec(model: str, in_features_ffnn: int | None = None) -> ModelSpec:
    if model == "FFNN":
        def init(generator, hp):
            return ffnn.init(generator, hp, in_features_ffnn), {}

        def apply_trials(params, bn_state, trials, inputs, train, row_mask,
                         compute_dtype, statics=None, shard=None, seed=0):
            logits = ffnn.apply_trials(
                params, trials, _ffnn_trials(inputs, len(trials)), train=train,
                compute_dtype=compute_dtype,
                max_width=(statics or {}).get("ffnn_max_width"))
            return logits, bn_state

        return _spec(model, ("ffnn",), init,
                     lambda hps: {"ffnn_max_width": _ffnn_width(hps, key=None)},
                     apply_trials,
                     fan_ins=lambda hp: ffnn.fan_ins(hp, in_features_ffnn))

    if model == "CNN":
        def apply_trials(params, bn_state, trials, inputs, train, row_mask,
                         compute_dtype, statics=None, shard=None, seed=0):
            st = statics or {}
            return cnn.apply_trials(
                params, bn_state, trials,
                _seq_trials(inputs, len(trials), compute_dtype), train=train,
                row_mask=row_mask, compute_dtype=compute_dtype,
                max_depth=st.get("cnn_max_depth"),
                max_channels=st.get("cnn_max_channels"),
                max_kernels=st.get("cnn_max_kernels"), shard=shard)

        return _spec(model, ("cnn",), cnn.init,
                     lambda hps: _cnn_statics(hps, key=None), apply_trials,
                     fan_ins=cnn.fan_ins)

    if model == "EmbraceNetMultimodal":
        def init(generator, hp):
            return embracenet.init(generator, hp, in_features_ffnn)

        def statics(hps):
            out = _cnn_statics(hps)
            out["ffnn_max_width"] = _ffnn_width(hps)
            out["embrace_max"] = max(int(hp["embrace_size"]) for hp in hps)
            out["post_max"] = _post_width(hps, "post_widths")
            return out

        def apply_trials(params, bn_state, trials, inputs, train, row_mask,
                         compute_dtype, statics=None, shard=None, seed=0):
            st = statics or {}
            return embracenet.apply_trials(
                params, bn_state, trials, _ffnn_trials(inputs, len(trials)),
                _seq_trials(inputs, len(trials), compute_dtype), train=train,
                seed=seed, row_mask=row_mask, compute_dtype=compute_dtype,
                cnn_max_depth=st.get("cnn_max_depth"),
                cnn_max_channels=st.get("cnn_max_channels"),
                cnn_max_kernels=st.get("cnn_max_kernels"),
                ffnn_max_width=st.get("ffnn_max_width"),
                embrace_max=st.get("embrace_max"), post_max=st.get("post_max"),
                fused=st.get("fused_embrace", False), shard=shard)

        return _spec(model, ("ffnn", "cnn"), init, statics, apply_trials,
                     fan_ins=lambda hp: embracenet.fan_ins(hp, in_features_ffnn))

    if model == "ConcatNetMultimodal":
        def init(generator, hp):
            return concatnet.init(generator, hp, in_features_ffnn)

        def statics(hps):
            out = _cnn_statics(hps)
            out["ffnn_max_width"] = _ffnn_width(hps)
            out["post_max"] = _post_width(hps, "post_widths")
            return out

        def apply_trials(params, bn_state, trials, inputs, train, row_mask,
                         compute_dtype, statics=None, shard=None, seed=0):
            st = statics or {}
            return concatnet.apply_trials(
                params, bn_state, trials, _ffnn_trials(inputs, len(trials)),
                _seq_trials(inputs, len(trials), compute_dtype), train=train,
                row_mask=row_mask, compute_dtype=compute_dtype,
                cnn_max_depth=st.get("cnn_max_depth"),
                cnn_max_channels=st.get("cnn_max_channels"),
                cnn_max_kernels=st.get("cnn_max_kernels"),
                ffnn_max_width=st.get("ffnn_max_width"),
                post_max=st.get("post_max"), shard=shard)

        return _spec(model, ("ffnn", "cnn"), init, statics, apply_trials,
                     fan_ins=lambda hp: concatnet.fan_ins(hp, in_features_ffnn))

    if model == "CNN_LSTM":
        def _arch(hp):
            return (int(hp["n_layers"]), tuple(int(c) for c in hp["channels"]),
                    tuple(int(k) for k in hp["kernels"]),
                    tuple(float(d) for d in hp["dropout"]),
                    int(hp["lstm_hidden"]), int(hp["lstm_layers"]))

        def statics(hp_list):
            archs = {_arch(hp) for hp in hp_list}
            if len(archs) != 1:
                raise ValueError("CNN_LSTM populations must share one "
                                 "architecture (shapes are trial-specific); "
                                 "run trials sequentially")
            return {"cnn_lstm_arch": archs.pop()}

        def apply_trials(params, bn_state, trials, inputs, train, row_mask,
                         compute_dtype, statics=None, shard=None, seed=0):
            return cnn_lstm.apply_trials(
                params, bn_state, trials,
                _seq_trials(inputs, len(trials), compute_dtype), train=train,
                row_mask=row_mask, compute_dtype=compute_dtype, shard=shard)

        # no fan-ins: parameter shapes follow the trial
        return _spec(model, ("cnn",), cnn_lstm.init, statics, apply_trials,
                     vmappable=False)

    raise ValueError(f"unknown model family: {model} (use one of {MODEL_FAMILIES})")
