"""CNN supernet, the DNA-sequence branch (port of
``embracenet_tpu/models/cnn.py``).

The reference's tunable 1-D CNN family — 1-4 blocks of ``Conv1d(same-pad,
k in {5,11,15}) + BatchNorm1d + ReLU + MaxPool1d(10, 2) + Dropout`` and a
purely linear FC head ``flat -> 1000 -> 64 -> 2``
(`BIOINF_tesi/models/CNN_net.py:10-83`, no activations in the head; headless
`CNN_pre.py:10-76`) — as one masked supernet: channel menus are channel
masks over (64, 96, 256, 512), the kernel menu a centered tap mask over 15
taps, depth a selection among the flatten candidates (the length trajectory
256 -> 124 -> 58 -> 25 -> 8 does not depend on the kernel).

Input: one-hot DNA ``[B, 4, 256]``.  Hyperparameters per trial:
``n_layers``, ``channels`` [4], ``kernels`` [4], ``dropout`` [4].  A
population runs as one program (:func:`features_trials`,
:func:`apply_trials`): its activations are ``[B, T, C, L]`` (NCW with the
trials' channels side by side), every block one convolution of all trials
(:func:`layers.conv1d_trials`), its BatchNorm per trial; :func:`features`
and :func:`apply` are one trial.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from embracenet_tpu_torch.config import (
    CNN_HEAD_FC,
    CNN_IN_CHANNELS,
    CNN_MAX_CHANNELS,
    CNN_MAX_KERNEL,
    CNN_MAX_LAYERS,
)
from embracenet_tpu_torch.models.layers import (
    Trials,
    batchnorm_init,
    batchnorm_trials,
    conv1d_trials,
    dropout_trials,
    kernel_tap_mask,
    linear,
    maxpool1d,
    one_trial,
    torch_uniform_init,
    width_mask,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS

#: flatten size of each depth candidate (channels_max * length)
FLAT_SIZES = tuple(c * l for c, l in zip(CNN_MAX_CHANNELS, CNN_LENGTHS))
FLAT_MAX = max(FLAT_SIZES)  # 7936 = 64 * 124


def fan_ins(hp, head: bool = True) -> np.ndarray:
    """Per-layer init fan-ins ``[CNN_MAX_LAYERS (+3 with head: flatten
    width, fc1, fc2)]``."""
    n_layers = int(hp["n_layers"])
    channels = [int(c) for c in hp["channels"]]
    kernels = [int(k) for k in hp["kernels"]]
    fans = []
    c_in_actual = CNN_IN_CHANNELS
    for i in range(CNN_MAX_LAYERS):
        fans.append(c_in_actual * kernels[i])
        if i < n_layers:
            c_in_actual = channels[i]
    if head:
        fans.append(channels[n_layers - 1] * CNN_LENGTHS[n_layers - 1])
        fans.extend(CNN_HEAD_FC)
    return np.asarray(fans, np.float32)


def init_from_fans(generator: torch.Generator, fans, n_classes: int = 2,
                   head: bool = True):
    params, bn_state = {}, {}
    for i in range(CNN_MAX_LAYERS):
        c_in_max = CNN_IN_CHANNELS if i == 0 else CNN_MAX_CHANNELS[i - 1]
        c_out_max = CNN_MAX_CHANNELS[i]
        params[f"conv_w{i}"] = torch_uniform_init(
            generator, (c_out_max, c_in_max, CNN_MAX_KERNEL), fans[i])
        params[f"conv_b{i}"] = torch_uniform_init(generator, (c_out_max,), fans[i])
        params[f"bn{i}"], bn_state[f"bn{i}"] = batchnorm_init(c_out_max)
    if head:
        f1, f2 = CNN_HEAD_FC
        params["w_fc1"] = torch_uniform_init(generator, (FLAT_MAX, f1), fans[-3])
        params["b_fc1"] = torch_uniform_init(generator, (f1,), fans[-3])
        params["w_fc2"] = torch_uniform_init(generator, (f1, f2), fans[-2])
        params["b_fc2"] = torch_uniform_init(generator, (f2,), fans[-2])
        params["w_head"] = torch_uniform_init(generator, (f2, n_classes), fans[-1])
        params["b_head"] = torch_uniform_init(generator, (n_classes,), fans[-1])
    return params, bn_state


def init(generator: torch.Generator, hp, n_classes: int = 2, head: bool = True):
    """Per-trial init with the trial's actual fan-ins (torch parity)."""
    return init_from_fans(generator, fan_ins(hp, head), n_classes, head)


def flat_bucket(max_depth: int, max_channels: tuple | None) -> int:
    """Flatten width of a (depth, channel) bucket — FLAT_MAX unsliced."""
    mc = max_channels or CNN_MAX_CHANNELS
    return max(mc[i] * CNN_LENGTHS[i] for i in range(max_depth))


def trial_channels(x, n_trials: int) -> torch.Tensor:
    """One-hot DNA for a population as the CNN lays it out, ``[B, T*4,
    L]``: ``x [B, 4, L]`` shared by every trial, or ``x [T, B, 4, L]``
    (per-trial batches)."""
    if x.dim() == 3:
        return x.repeat(1, n_trials, 1)
    return x.transpose(0, 1).reshape(x.shape[1], -1, x.shape[-1])


def features_trials(params, bn_state, trials: Trials, x, *,
                    train: bool = False, row_mask=None, compute_dtype=None,
                    max_depth: int | None = None,
                    max_channels: tuple | None = None,
                    max_kernels: tuple | None = None, shard=None):
    """Headless forward of a population (reference ``CNN_pre``) ->
    ``(flat [T, B, FB], flat_mask [T, FB], new_bn_state)`` with
    ``FB = flat_bucket(max_depth, max_channels)``.

    ``x [B, T*4, 256]`` (:func:`trial_channels`); params and BN state
    leaves ``[T, ...]``, ``row_mask [T, B]``.  Every block is one
    convolution of all trials (``conv1d_trials``), whose activations stay
    ``[B, T, C, L]``.
    ``max_depth`` computes only the first ``max_depth`` blocks (the
    caller passes the population's deepest trial); ``max_channels`` and
    ``max_kernels`` slice weights to the population's per-layer maxima
    (exact, see the JAX module).  Params keep full supernet shapes; BN
    state is written back into full-shape buffers.  ``shard``: this
    rank's rows of a data-sharded batch (``parallel.mesh.BatchShard``:
    BatchNorm moments summed over the data axis, dropout drawn by global
    row).
    """
    hp, n_host = trials.hp, trials.ints("n_layers")
    n_trials, b, dev = len(trials), x.shape[0], x.device
    max_depth = max_depth or CNN_MAX_LAYERS
    mc = tuple(max_channels) if max_channels else CNN_MAX_CHANNELS
    flat_bk = flat_bucket(max_depth, mc)

    new_bn_state = dict(bn_state)
    h = x  # [B, T*4, 256]
    flats = []
    for i in range(max_depth):
        c_in = CNN_IN_CHANNELS if i == 0 else mc[i - 1]
        c_out = mc[i]
        mk = max_kernels[i] if max_kernels else CNN_MAX_KERNEL
        lo = (CNN_MAX_KERNEL - mk) // 2
        tap = kernel_tap_mask(mk, hp["kernels"][:, i], dev)[:, None, None, :]
        w = params[f"conv_w{i}"][:, :c_out, :c_in, lo:lo + mk] * tap
        z = conv1d_trials(h, w, compute_dtype)
        z = z.view(b, n_trials, c_out, -1) \
            + params[f"conv_b{i}"][:, :c_out][None, :, :, None]
        bn_p = {k: v[:, :c_out] for k, v in params[f"bn{i}"].items()}
        bn_s = {k: v[:, :c_out] for k, v in bn_state[f"bn{i}"].items()}
        z, bn_new = batchnorm_trials(z, bn_p, bn_s, train, row_mask, shard)
        new_bn_state[f"bn{i}"] = {
            k: torch.cat([bn_new[k], bn_state[f"bn{i}"][k][:, c_out:]], dim=1)
            for k in bn_new}
        z = maxpool1d(torch.relu(z).view(b, n_trials * c_out, -1))
        z = z.view(b, n_trials, c_out, -1)
        if train:
            # a block beyond a trial's depth draws no dropout for it:
            # nothing of the trial reads it, and so its generator's later
            # draws (modality dropout, embracement, post layers) do not
            # depend on how deep the population's deepest trial is
            length = z.shape[-1]
            own = trials.own_shapes("cnn_max_channels", mc, CNN_MAX_CHANNELS,
                                    lambda m, i=i, n=length: (m[i], n))
            u = trials.draws.rand(b, own, (c_out, length),
                                  [i < n for n in n_host])
            z = dropout_trials(z, hp["dropout"][:, i] * (i < hp["n_layers"]),
                               u.transpose(0, 1), train, trial_dim=1)
        z = z * width_mask(c_out, hp["channels"][:, i], dev)[None, :, :, None]
        flat = z.transpose(0, 1).reshape(n_trials, b, -1)
        flats.append(F.pad(flat, (0, flat_bk - flat.shape[2])))
        h = z.reshape(b, n_trials * c_out, -1)

    # depth selection among the flatten candidates, per trial; valid
    # features occupy [0, channels * length) (channel-major flatten)
    n_layers = hp["n_layers"]
    out = flats[0]
    flat_valid = hp["channels"][:, 0].long() * CNN_LENGTHS[0]
    for d in range(1, max_depth):
        deeper = n_layers > d
        out = torch.where(deeper[:, None, None], flats[d], out)
        flat_valid = torch.where(
            deeper, hp["channels"][:, d].long() * CNN_LENGTHS[d], flat_valid)
    flat_mask = width_mask(flat_bk, flat_valid, dev)
    return out * flat_mask[:, None, :], flat_mask, new_bn_state


def apply_trials(params, bn_state, trials: Trials, x, *, train: bool = False,
                 row_mask=None, compute_dtype=None,
                 max_depth: int | None = None,
                 max_channels: tuple | None = None,
                 max_kernels: tuple | None = None, shard=None):
    """Headful forward of a population -> (logits [T, B, n_classes],
    new_bn_state).  The FC head is linear->linear->linear with no
    activations (`CNN_net.py:77-83`)."""
    flat, _, new_bn_state = features_trials(
        params, bn_state, trials, x, train=train, row_mask=row_mask,
        compute_dtype=compute_dtype, max_depth=max_depth,
        max_channels=max_channels, max_kernels=max_kernels, shard=shard)
    h = linear(flat, params["w_fc1"][:, :flat.shape[2], :], params["b_fc1"],
               compute_dtype)
    h = linear(h, params["w_fc2"], params["b_fc2"], compute_dtype)
    return (linear(h, params["w_head"], params["b_head"], compute_dtype),
            new_bn_state)


def features(params, bn_state, hp, x, *, train: bool = False, generator=None,
             row_mask=None, compute_dtype=None, max_depth: int | None = None,
             max_channels: tuple | None = None,
             max_kernels: tuple | None = None, shard=None):
    """Headless forward of one trial, ``x [B, 4, 256]`` ->
    ``(flat [B, FB], flat_mask [FB], new_bn_state)``:
    :func:`features_trials` of a population of one."""
    trials, stack, unstack = one_trial(hp, x.shape[0], x.device, generator,
                                       train, shard)
    flat, flat_mask, new_bn = features_trials(
        stack(params), stack(bn_state), trials, x, train=train,
        row_mask=stack(row_mask), compute_dtype=compute_dtype,
        max_depth=max_depth, max_channels=max_channels,
        max_kernels=max_kernels, shard=shard)
    return flat[0], flat_mask[0], unstack(new_bn)


def apply(params, bn_state, hp, x, *, train: bool = False, generator=None,
          row_mask=None, compute_dtype=None, max_depth: int | None = None,
          max_channels: tuple | None = None,
          max_kernels: tuple | None = None, shard=None):
    """Headful forward of one trial -> (logits [B, n_classes],
    new_bn_state)."""
    trials, stack, unstack = one_trial(hp, x.shape[0], x.device, generator,
                                       train, shard)
    logits, new_bn = apply_trials(
        stack(params), stack(bn_state), trials, x, train=train,
        row_mask=stack(row_mask), compute_dtype=compute_dtype,
        max_depth=max_depth, max_channels=max_channels,
        max_kernels=max_kernels, shard=shard)
    return logits[0], unstack(new_bn)
