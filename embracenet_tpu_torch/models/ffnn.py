"""FFNN supernet, the epigenomic-feature branch (port of
``embracenet_tpu/models/ffnn.py``).

The reference's tunable MLP family — 1-4 Linear+ReLU+Dropout blocks with
per-layer width menus and a ``Linear(., 2)`` head
(`BIOINF_tesi/models/FF_net.py:8-50`; headless `FFNN_pre.py:8-49`) — as one
fixed-shape masked supernet: every hidden layer lives in ``H = 256``
features, widths are column masks, depth is pass-through selection.

Hyperparameters are concrete per trial: ``n_layers`` int, ``widths`` [4],
``dropout`` [4] (numpy, as ``hpo.space.params_to_hp`` gives them).
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.config import FFNN_MAX_LAYERS, FFNN_MAX_WIDTH
from embracenet_tpu_torch.models.layers import (
    dropout as _dropout,
    linear,
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


def features(params, hp, x, *, train: bool = False, generator=None,
             compute_dtype=None, max_width: int | None = None, shard=None):
    """Headless forward -> ([B, W] masked features, [W] output mask).

    ``max_width`` (<= H) is the population's width bucket: weights are
    sliced so the hidden space costs W instead of H (exact: masked
    features beyond any trial's width are zero and live ones a prefix).
    Layers beyond ``n_layers`` pass their input through, so they are not
    computed.  ``shard``: this rank's rows of a data-sharded batch
    (``parallel.mesh.BatchShard``; dropout draws by global row).
    """
    n_layers = int(hp["n_layers"])
    W = max_width or H
    h = out_mask = None
    for i in range(n_layers):
        inp = x if i == 0 else h
        w = params[f"w{i}"][:, :W] if i == 0 else params[f"w{i}"][:W, :W]
        mask = width_mask(W, hp["widths"][i], x.device)
        z = torch.relu(linear(inp, w, params[f"b{i}"][:W], compute_dtype)) * mask
        h = _dropout(z, hp["dropout"][i], generator, train, shard) * mask
        out_mask = mask
    return h, out_mask


def apply(params, hp, x, *, train: bool = False, generator=None,
          compute_dtype=None, max_width: int | None = None, shard=None):
    """Headful forward -> logits [B, n_classes] (reference ``FFNN``)."""
    h, _ = features(params, hp, x, train=train, generator=generator,
                    compute_dtype=compute_dtype, max_width=max_width,
                    shard=shard)
    return linear(h, params["w_head"][:h.shape[1], :], params["b_head"],
                  compute_dtype)
