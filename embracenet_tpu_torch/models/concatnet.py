"""ConcatNet multimodal baseline, supernet form (port of
``embracenet_tpu/models/concatnet.py``).

Reference: `BIOINF_tesi/models/ConcatNetMultimodal.py:12-83` — FFNN_pre +
CNN_pre branches, feature concatenation (`:76`), 1-3 post
Linear+ReLU+Dropout layers (width menus (512,768,1024) / (32..512) /
(16..256)) and a ``Linear(., 2)`` head.

Hyperparameters: ``ffnn`` sub-dict, ``cnn`` sub-dict, ``n_post`` (1..3),
``post_widths`` [3], ``post_dropout`` [3].  A population runs as one
program (:func:`apply_trials`), each trial's dropout drawn from its own
generator; one trial's draws (:func:`apply`) come from a
``torch.Generator`` seeded with ``seed`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.config import CONCAT_MAX_POST_LAYERS, FFNN_MAX_WIDTH
from embracenet_tpu_torch.models import cnn as cnn_mod
from embracenet_tpu_torch.models import ffnn as ffnn_mod
from embracenet_tpu_torch.models.cnn import FLAT_MAX
from embracenet_tpu_torch.models.layers import (
    Trials,
    dropout_trials,
    linear,
    one_trial,
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


def apply_trials(params, bn_state, trials: Trials, x_ffnn, x_cnn, *,
                 train: bool = False, row_mask=None, compute_dtype=None,
                 cnn_max_depth: int | None = None,
                 cnn_max_channels: tuple | None = None,
                 cnn_max_kernels: tuple | None = None,
                 ffnn_max_width: int | None = None,
                 post_max: int | None = None, shard=None):
    """Forward of a population of T trials -> (logits [T, B, 2],
    new_bn_state); params and BN state leaves ``[T, ...]``, ``x_ffnn [T,
    B, F]``, ``x_cnn [B, T*4, 256]`` (``cnn.trial_channels``),
    ``row_mask [T, B]``.

    The ``*_max`` statics are width buckets (population maxima): weights
    are sliced to the bucket dims, exactly equivalent to the full supernet.
    The post layers run to the population's deepest trial (the JAX package
    computes all three and selects); one beyond a trial's ``n_post``
    passes its input through and draws nothing for it.  The first always
    runs, as there.  ``shard``: this rank's rows of a data-sharded batch
    (``parallel.mesh.BatchShard``).
    """
    hp, n_trials = trials.hp, len(trials)
    PB = post_max or P

    f_ffnn, _ = ffnn_mod.features_trials(params["ffnn"], trials.sub("ffnn"),
                                         x_ffnn, train=train,
                                         compute_dtype=compute_dtype,
                                         max_width=ffnn_max_width)
    f_cnn, _, new_bn_state = cnn_mod.features_trials(
        params["cnn"], bn_state, trials.sub("cnn"), x_cnn, train=train,
        row_mask=row_mask, compute_dtype=compute_dtype,
        max_depth=cnn_max_depth, max_channels=cnn_max_channels,
        max_kernels=cnn_max_kernels, shard=shard)

    h = torch.cat([f_ffnn, f_cnn], dim=-1)  # [T, B, FW + FB]
    b, dev = h.shape[1], h.device
    # post_w0 rows follow the [FFNN_MAX_WIDTH | FLAT_MAX] concat layout;
    # pick the bucketed rows of each block to match h = [FW | FB].  A
    # pre-shrunk leaf (training/slicing.py) already has the bucket layout,
    # told by its row count
    if params["post_w0"].shape[1] == h.shape[2]:
        w0 = params["post_w0"][:, :, :PB]
    else:
        w0 = torch.cat([params["post_w0"][:, :f_ffnn.shape[2]],
                        params["post_w0"][:, FFNN_MAX_WIDTH:
                                          FFNN_MAX_WIDTH + f_cnn.shape[2]]],
                       dim=1)[:, :, :PB]
    depth = hp["n_post"].clamp(min=1)
    n_host = [max(n, 1) for n in trials.ints("n_post")]
    own = trials.own_shapes("post_max", PB, P, lambda w: (w,))
    out = h
    for i in range(max(n_host)):
        w = w0 if i == 0 else params[f"post_w{i}"][:, :PB, :PB]
        mask = width_mask(PB, hp["post_widths"][:, i], dev)[:, None, :]
        z = torch.relu(linear(out, w, params[f"post_b{i}"][:, :PB],
                              compute_dtype)) * mask
        if train:
            u = trials.draws.rand(b, own, (PB,), [i < n for n in n_host])
            z = dropout_trials(z, hp["post_dropout"][:, i] * (i < depth), u,
                               train)
        z = z * mask
        out = z if i == 0 else torch.where((i < depth)[:, None, None], z, out)

    logits = linear(out, params["head_w"][:, :PB, :], params["head_b"],
                    compute_dtype)
    return logits, new_bn_state


def apply(params, bn_state, hp, x_ffnn, x_cnn, *, train: bool = False,
          seed: int = 0, row_mask=None, compute_dtype=None,
          cnn_max_depth: int | None = None,
          cnn_max_channels: tuple | None = None,
          cnn_max_kernels: tuple | None = None,
          ffnn_max_width: int | None = None,
          post_max: int | None = None, shard=None):
    """Forward of one trial -> (logits [B, 2], new_bn_state):
    :func:`apply_trials` of a population of one, its draws from a
    ``torch.Generator`` seeded with ``seed``."""
    trials, stack, unstack = one_trial(hp, x_ffnn.shape[0], x_ffnn.device,
                                       seed, train, shard)
    logits, new_bn = apply_trials(
        stack(params), stack(bn_state), trials, x_ffnn[None], x_cnn,
        train=train, row_mask=stack(row_mask), compute_dtype=compute_dtype,
        cnn_max_depth=cnn_max_depth, cnn_max_channels=cnn_max_channels,
        cnn_max_kernels=cnn_max_kernels, ffnn_max_width=ffnn_max_width,
        post_max=post_max, shard=shard)
    return logits[0], unstack(new_bn)
