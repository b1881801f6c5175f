"""ConcatNet multimodal baseline, supernet form (port of
``embracenet_tpu/models/concatnet.py``).

Reference: `BIOINF_tesi/models/ConcatNetMultimodal.py:12-83` — FFNN_pre +
CNN_pre branches, feature concatenation (`:76`), 1-3 post
Linear+ReLU+Dropout layers (width menus (512,768,1024) / (32..512) /
(16..256)) and a ``Linear(., 2)`` head.

Hyperparameters: ``ffnn`` sub-dict, ``cnn`` sub-dict, ``n_post`` (1..3),
``post_widths`` [3], ``post_dropout`` [3].  Random draws (dropout) come
from a ``torch.Generator`` seeded with ``seed`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.config import CONCAT_MAX_POST_LAYERS, FFNN_MAX_WIDTH
from embracenet_tpu_torch.models import cnn as cnn_mod
from embracenet_tpu_torch.models import ffnn as ffnn_mod
from embracenet_tpu_torch.models.cnn import FLAT_MAX
from embracenet_tpu_torch.models.layers import (
    dropout as _dropout,
    linear,
    torch_uniform_init,
    width_mask,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS

CONCAT_DIM = FFNN_MAX_WIDTH + FLAT_MAX   # 256 + 7936
P = 1024                                 # post space (max width menu)


def fan_ins(hp, in_features_ffnn: int) -> dict:
    """Concrete init fan-ins: the branches', the post chain's and the
    head's."""
    n_post = int(hp["n_post"])
    post_widths = [int(w) for w in hp["post_widths"]]
    ffnn_out = int(hp["ffnn"]["widths"][int(hp["ffnn"]["n_layers"]) - 1])
    cnn_depth = int(hp["cnn"]["n_layers"])
    cnn_out = int(hp["cnn"]["channels"][cnn_depth - 1]) * CNN_LENGTHS[cnn_depth - 1]

    post = []
    fan_in = ffnn_out + cnn_out
    for i in range(CONCAT_MAX_POST_LAYERS):
        post.append(fan_in)
        if i < n_post:
            fan_in = post_widths[i]
    return {"ffnn": ffnn_mod.fan_ins(hp["ffnn"], in_features_ffnn, head=False),
            "cnn": cnn_mod.fan_ins(hp["cnn"], head=False),
            "post": np.asarray(post, np.float32),
            "head": np.asarray(fan_in, np.float32)}


def init_from_fans(generator: torch.Generator, fans, in_features_ffnn: int,
                   n_classes: int = 2):
    params = {"ffnn": ffnn_mod.init_from_fans(generator, fans["ffnn"],
                                              in_features_ffnn, head=False)}
    params["cnn"], bn_state = cnn_mod.init_from_fans(generator, fans["cnn"],
                                                     head=False)
    for i in range(CONCAT_MAX_POST_LAYERS):
        d_in = CONCAT_DIM if i == 0 else P
        params[f"post_w{i}"] = torch_uniform_init(generator, (d_in, P),
                                                  fans["post"][i])
        params[f"post_b{i}"] = torch_uniform_init(generator, (P,),
                                                  fans["post"][i])
    params["head_w"] = torch_uniform_init(generator, (P, n_classes), fans["head"])
    params["head_b"] = torch_uniform_init(generator, (n_classes,), fans["head"])
    return params, bn_state


def init(generator: torch.Generator, hp, in_features_ffnn: int,
         n_classes: int = 2):
    return init_from_fans(generator, fan_ins(hp, in_features_ffnn),
                          in_features_ffnn, n_classes)


def apply(params, bn_state, hp, x_ffnn, x_cnn, *, train: bool = False,
          seed: int = 0, row_mask=None, compute_dtype=None,
          cnn_max_depth: int | None = None,
          cnn_max_channels: tuple | None = None,
          cnn_max_kernels: tuple | None = None,
          ffnn_max_width: int | None = None,
          post_max: int | None = None, shard=None):
    """Forward -> (logits [B, 2], new_bn_state).

    The ``*_max`` statics are width buckets (population maxima): weights
    are sliced to the bucket dims, exactly equivalent to the full supernet.
    Post layers beyond ``n_post`` pass their input through, so they are not
    computed (the JAX package computes all three and selects); the first
    always runs, as there.  ``shard``: this rank's rows of a data-sharded
    batch (``parallel.mesh.BatchShard``).
    """
    gen = torch.Generator(device=x_ffnn.device).manual_seed(int(seed))
    PB = post_max or P

    f_ffnn, _ = ffnn_mod.features(params["ffnn"], hp["ffnn"], x_ffnn,
                                  train=train, generator=gen,
                                  compute_dtype=compute_dtype,
                                  max_width=ffnn_max_width, shard=shard)
    f_cnn, _, new_bn_state = cnn_mod.features(
        params["cnn"], bn_state, hp["cnn"], x_cnn, train=train, generator=gen,
        row_mask=row_mask, compute_dtype=compute_dtype,
        max_depth=cnn_max_depth, max_channels=cnn_max_channels,
        max_kernels=cnn_max_kernels, shard=shard)

    h = torch.cat([f_ffnn, f_cnn], dim=-1)  # [B, FW + FB]
    # post_w0 rows follow the [FFNN_MAX_WIDTH | FLAT_MAX] concat layout;
    # pick the bucketed rows of each block to match h = [FW | FB].  A
    # pre-shrunk leaf (training/slicing.py) already has the bucket layout,
    # told by its row count
    if params["post_w0"].shape[0] == h.shape[1]:
        w0 = params["post_w0"][:, :PB]
    else:
        w0 = torch.cat([params["post_w0"][:f_ffnn.shape[1]],
                        params["post_w0"][FFNN_MAX_WIDTH:
                                          FFNN_MAX_WIDTH + f_cnn.shape[1]]],
                       dim=0)[:, :PB]
    out = h
    for i in range(max(int(hp["n_post"]), 1)):
        w = w0 if i == 0 else params[f"post_w{i}"][:PB, :PB]
        mask = width_mask(PB, hp["post_widths"][i], h.device)
        z = torch.relu(linear(out, w, params[f"post_b{i}"][:PB],
                              compute_dtype)) * mask
        out = _dropout(z, hp["post_dropout"][i], gen, train, shard) * mask

    logits = linear(out, params["head_w"][:PB, :], params["head_b"],
                    compute_dtype)
    return logits, new_bn_state
