"""FFNN supernet, the epigenomic-feature branch (port of
``embracenet_tpu/models/ffnn.py``).

The reference's tunable MLP family — 1-4 Linear+ReLU+Dropout blocks with
per-layer width menus and a ``Linear(., 2)`` head
(`BIOINF_tesi/models/FF_net.py:8-50`; headless `FFNN_pre.py:8-49`) — as one
fixed-shape masked supernet: every hidden layer lives in ``H = 256``
features, widths are column masks, depth is pass-through selection.

Hyperparameters per trial: ``n_layers`` int, ``widths`` [4], ``dropout``
[4] (numpy, as ``hpo.space.params_to_hp`` gives them).  A population runs
as one program (:func:`features_trials`, :func:`apply_trials`: the
hyperparameters stacked ``[T, ...]`` in a ``layers.Trials``, the layers to
the deepest trial, depth a pass-through select as in the JAX supernet);
:func:`features` and :func:`apply` are one trial, a population of one.
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.config import FFNN_MAX_LAYERS, FFNN_MAX_WIDTH
from embracenet_tpu_torch.models.layers import (
    Trials,
    dropout_trials,
    linear,
    one_trial,
    torch_uniform_init,
    width_mask,
)

H = FFNN_MAX_WIDTH  # 256


def fan_ins(hp, in_features: int, head: bool = True) -> np.ndarray:
    """Per-layer init fan-ins ``[FFNN_MAX_LAYERS (+1 with head)]``."""
    n_layers = int(hp["n_layers"])
    widths = [int(w) for w in hp["widths"]]
    fans = []
    fan_in = in_features
    for i in range(FFNN_MAX_LAYERS):
        fans.append(fan_in)
        if i < n_layers:
            fan_in = widths[i]
    if head:
        fans.append(fan_in)
    return np.asarray(fans, np.float32)


def init_from_fans(generator: torch.Generator, fans, in_features: int,
                   n_classes: int = 2, head: bool = True) -> dict:
    params = {}
    for i in range(FFNN_MAX_LAYERS):
        d_in = in_features if i == 0 else H
        params[f"w{i}"] = torch_uniform_init(generator, (d_in, H), fans[i])
        params[f"b{i}"] = torch_uniform_init(generator, (H,), fans[i])
    if head:
        params["w_head"] = torch_uniform_init(generator, (H, n_classes), fans[-1])
        params["b_head"] = torch_uniform_init(generator, (n_classes,), fans[-1])
    return params


def init(generator: torch.Generator, hp, in_features: int, n_classes: int = 2,
         head: bool = True) -> dict:
    """Per-trial parameter init with the trial's *actual* fan-ins."""
    return init_from_fans(generator, fan_ins(hp, in_features, head),
                          in_features, n_classes, head)


def features_trials(params, trials: Trials, x, *, train: bool = False,
                    compute_dtype=None, max_width: int | None = None):
    """Headless forward of a population -> ``([T, B, W] masked features,
    [T, W] output masks)``; params leaves ``[T, ...]``, ``x [T, B, in]``.

    ``max_width`` (<= H) is the population's width bucket: weights are
    sliced so the hidden space costs W instead of H (exact: masked
    features beyond any trial's width are zero and live ones a prefix).
    The layers run to the population's deepest trial; a layer beyond a
    trial's depth passes its input through (a select, as the JAX supernet)
    and draws no dropout for it.  Each trial draws from its own generator
    at its own width (``trials.draws``).
    """
    hp, n_host = trials.hp, trials.ints("n_layers")
    W = max_width or H
    dev, b = x.device, x.shape[1]
    own = trials.own_shapes("ffnn_max_width", W, H, lambda w: (w,))
    h = out_mask = None
    for i in range(max(n_host)):
        inp = x if i == 0 else h
        w = params[f"w{i}"][:, :, :W] if i == 0 else params[f"w{i}"][:, :W, :W]
        mask = width_mask(W, hp["widths"][:, i], dev)[:, None, :]
        z = torch.relu(linear(inp, w, params[f"b{i}"][:, :W],
                              compute_dtype)) * mask
        if train:
            live = [i < n for n in n_host]
            u = trials.draws.rand(b, own, (W,), live)
            z = dropout_trials(z, hp["dropout"][:, i] * (i < hp["n_layers"]),
                               u, train)
        z = z * mask
        if i == 0:
            h, out_mask = z, mask[:, 0]
        else:
            active = i < hp["n_layers"]
            h = torch.where(active[:, None, None], z, h)
            out_mask = torch.where(active[:, None], mask[:, 0], out_mask)
    return h, out_mask


def apply_trials(params, trials: Trials, x, *, train: bool = False,
                 compute_dtype=None, max_width: int | None = None):
    """Headful forward of a population -> logits ``[T, B, n_classes]``."""
    h, _ = features_trials(params, trials, x, train=train,
                           compute_dtype=compute_dtype, max_width=max_width)
    return linear(h, params["w_head"][:, :h.shape[2], :], params["b_head"],
                  compute_dtype)


def features(params, hp, x, *, train: bool = False, generator=None,
             compute_dtype=None, max_width: int | None = None, shard=None):
    """Headless forward of one trial -> ([B, W] masked features, [W] output
    mask): :func:`features_trials` of a population of one.  ``shard``: this
    rank's rows of a data-sharded batch (``parallel.mesh.BatchShard``;
    dropout draws by global row)."""
    trials, stack, _ = one_trial(hp, x.shape[0], x.device, generator, train,
                                 shard)
    h, out_mask = features_trials(stack(params), trials, x[None], train=train,
                                  compute_dtype=compute_dtype,
                                  max_width=max_width)
    return h[0], out_mask[0]


def apply(params, hp, x, *, train: bool = False, generator=None,
          compute_dtype=None, max_width: int | None = None, shard=None):
    """Headful forward of one trial -> logits [B, n_classes] (reference
    ``FFNN``)."""
    trials, stack, _ = one_trial(hp, x.shape[0], x.device, generator, train,
                                 shard)
    return apply_trials(stack(params), trials, x[None], train=train,
                        compute_dtype=compute_dtype, max_width=max_width)[0]
