"""CNN+LSTM sequence model (port of ``embracenet_tpu/models/cnn_lstm.py``;
reference `BIOINF_tesi/models/CNN_LSTM_net.py`).

Architecture: 1-2 conv blocks (the CNN's first two menus), then the conv
output ``[B, C, L]`` is reshaped to ``[B, C*L/4, 4]`` and fed to an
``LSTM(4 -> hidden in {32, 64, 128}, 1-2 layers)``; the flattened LSTM
outputs pass through ``Linear(., 1000) -> Linear(1000, 64) -> Linear(64,
2)`` with no activations (`CNN_LSTM_net.py:78-95`).  The first FC layer
has learned parameters (the JAX package's stated divergence from the
reference, which re-creates it in every forward pass).

Layouts are the JAX package's, so weights convert with a plain copy:
``lstm`` is a list of layers, each ``w_ih [in, 4H]``, ``w_hh [H, 4H]``,
``b_ih``, ``b_hh [4H]``, gate order i, f, g, o (torch's).  The JAX package
runs the recurrence as a ``lax.scan``; here it is one call of torch's LSTM
(cuDNN on the card, with TF32 off, as the convolutions run), so a forward
pass launches no kernel per timestep: the widest trial has 1,984 of them.
Under ``compute_dtype="bfloat16"`` only the convolutions run in bf16, as
in the JAX package; the LSTM and the linears run in float32.

Hyperparameters (concrete per trial): ``n_layers`` (1-2), ``channels``,
``kernels``, ``dropout`` (conv part), ``lstm_hidden`` in {32, 64, 128},
``lstm_layers`` (1-2).
"""

from __future__ import annotations

import torch

from embracenet_tpu_torch.config import CNN_LSTM_HIDDEN_MENU
from embracenet_tpu_torch.models.layers import (
    Trials,
    batchnorm_init,
    batchnorm_trials,
    conv1d_trials,
    dropout_trials,
    exact_float32,
    linear,
    maxpool1d,
    one_trial,
    torch_uniform_init,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS
from embracenet_tpu_torch.utils.profiling import annotate, count

LSTM_HIDDEN_MENU = CNN_LSTM_HIDDEN_MENU


def _lstm_init(generator, input_size, hidden, n_layers):
    """torch nn.LSTM default init: U(-1/sqrt(hidden), 1/sqrt(hidden))."""
    params = []
    for layer in range(n_layers):
        d_in = input_size if layer == 0 else hidden
        params.append({
            "w_ih": torch_uniform_init(generator, (d_in, 4 * hidden), hidden),
            "w_hh": torch_uniform_init(generator, (hidden, 4 * hidden), hidden),
            "b_ih": torch_uniform_init(generator, (4 * hidden,), hidden),
            "b_hh": torch_uniform_init(generator, (4 * hidden,), hidden),
        })
    return params


#: rows x timesteps x gate units x layers of one cuDNN LSTM call: its
#: workspace grows with it (a 4,096-row batch of the widest trial asked
#: for 81.5 GiB), so larger batches on the card go through in row chunks
LSTM_CHUNK = 1 << 28


def _chunk_rows(x: torch.Tensor, hidden: int, n_layers: int) -> int:
    """Rows of ``x`` one call of torch's LSTM takes: a chunk of
    :data:`LSTM_CHUNK` on the card, all of them on the CPU."""
    if not x.is_cuda:
        return len(x)
    return max(1, LSTM_CHUNK // (x.shape[1] * 4 * hidden * n_layers))


def lstm_apply(params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """x: [B, T, D] -> outputs [B, T, H] of the stacked LSTM (batch first,
    zero initial state), as calls of torch's LSTM: cuDNN's on the card
    (with TF32 off), in chunks of rows that bound one call's workspace
    (:data:`LSTM_CHUNK`; rows are independent), and ATen's on the CPU, in
    one call.  ``train`` keeps what the backward pass needs.

    Each call is one ``cnn_lstm.lstm`` span (its backward pass is the
    library's own op, ``aten::_cudnn_rnn_backward`` on the card) and adds
    its timesteps x layers to the ``cnn_lstm.lstm_steps`` counter once,
    whatever its row chunks."""
    hidden = params[0]["w_hh"].shape[0]
    flat = []
    for lp in params:   # torch's layout: w_ih [4H, in], w_hh [4H, H]
        flat += [lp["w_ih"].to(x.dtype).t().contiguous(),
                 lp["w_hh"].to(x.dtype).t().contiguous(),
                 lp["b_ih"].to(x.dtype), lp["b_hh"].to(x.dtype)]
    rows = _chunk_rows(x, hidden, len(params))
    count("cnn_lstm.lstm_steps", x.shape[1] * len(params))
    outs = []
    with annotate("cnn_lstm.lstm"), exact_float32():
        for chunk in x.split(rows):
            h0 = chunk.new_zeros((len(params), chunk.shape[0], hidden))
            outs.append(torch._VF.lstm(chunk, (h0, h0), flat, True,
                                       len(params), 0.0, train, False,
                                       True)[0])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def timesteps(hp) -> int:
    depth = int(hp["n_layers"])
    c = int(hp["channels"][depth - 1])
    length = CNN_LENGTHS[depth - 1]
    if (c * length) % 4:
        raise ValueError(f"conv output {c} x {length} does not split into "
                         "steps of 4")
    return c * length // 4


def init(generator: torch.Generator, hp, n_classes: int = 2):
    depth = int(hp["n_layers"])
    if depth > 2:
        raise ValueError("the reference CNN_LSTM uses 1-2 conv blocks")
    params, bn_state = {}, {}
    c_in = 4
    for i in range(depth):
        c_out = int(hp["channels"][i])
        k = int(hp["kernels"][i])
        fan_in = c_in * k
        params[f"conv_w{i}"] = torch_uniform_init(generator, (c_out, c_in, k),
                                                  fan_in)
        params[f"conv_b{i}"] = torch_uniform_init(generator, (c_out,), fan_in)
        params[f"bn{i}"], bn_state[f"bn{i}"] = batchnorm_init(c_out)
        c_in = c_out

    hidden = int(hp["lstm_hidden"])
    params["lstm"] = _lstm_init(generator, 4, hidden, int(hp["lstm_layers"]))
    flat = timesteps(hp) * hidden
    params["w_fc1"] = torch_uniform_init(generator, (flat, 1000), flat)
    params["b_fc1"] = torch_uniform_init(generator, (1000,), flat)
    params["w_fc2"] = torch_uniform_init(generator, (1000, 64), 1000)
    params["b_fc2"] = torch_uniform_init(generator, (64,), 1000)
    params["w_head"] = torch_uniform_init(generator, (64, n_classes), 64)
    params["b_head"] = torch_uniform_init(generator, (n_classes,), 64)
    return params, bn_state


def apply_trials(params, bn_state, trials: Trials, x, *, train: bool = False,
                 row_mask=None, compute_dtype=None, shard=None):
    """Forward of a population of T trials of one architecture (CNN_LSTM's
    parameter shapes follow it) -> (logits [T, B, 2], new_bn_state);
    params and BN state leaves ``[T, ...]``, ``x [B, T*4, 256]``
    (``cnn.trial_channels``), ``row_mask [T, B]``.  The conv blocks run
    as one convolution of all trials each (``layers.conv1d_trials``) and
    the FC layers as batched products; the recurrence is one call of
    torch's LSTM per trial (a stated divergence: cuDNN takes no trial
    axis).  ``shard``: this rank's
    rows of a data-sharded batch (``parallel.mesh.BatchShard``)."""
    hp, n_trials = trials.hp, len(trials)
    depth = trials.ints("n_layers")[0]
    b = x.shape[0]
    new_bn = dict(bn_state)
    h = x
    for i in range(depth):
        c_out = params[f"conv_w{i}"].shape[1]
        z = conv1d_trials(h, params[f"conv_w{i}"], compute_dtype)
        z = z.view(b, n_trials, c_out, -1) \
            + params[f"conv_b{i}"][None, :, :, None]
        z, new_bn[f"bn{i}"] = batchnorm_trials(z, params[f"bn{i}"],
                                               bn_state[f"bn{i}"], train,
                                               row_mask, shard)
        z = maxpool1d(torch.relu(z).view(b, n_trials * c_out, -1))
        z = z.view(b, n_trials, c_out, -1)
        if train:
            u = trials.draws.rand(b, [tuple(z.shape[2:])] * n_trials,
                                  tuple(z.shape[2:]))
            z = dropout_trials(z, hp["dropout"][:, i], u.transpose(0, 1),
                               train, trial_dim=1)
        h = z.reshape(b, n_trials * c_out, -1)
    seq = h.view(b, n_trials, -1).transpose(0, 1).reshape(n_trials, b, -1, 4)
    out = torch.stack([
        lstm_apply([{k: v[t] for k, v in layer.items()}
                    for layer in params["lstm"]], seq[t], train)
        for t in range(n_trials)])            # [T, B, C*L/4, H] (reference :84)
    z = linear(out.reshape(n_trials, b, -1), params["w_fc1"], params["b_fc1"])
    z = linear(z, params["w_fc2"], params["b_fc2"])
    return linear(z, params["w_head"], params["b_head"]), new_bn


def apply(params, bn_state, hp, x, *, train: bool = False, seed: int = 0,
          row_mask=None, compute_dtype=None, shard=None):
    """x: one-hot [B, 4, 256] -> (logits [B, 2], new_bn_state):
    :func:`apply_trials` of a population of one, its draws from a
    ``torch.Generator`` seeded with ``seed``; ``shard``: this rank's rows
    of a data-sharded batch (``parallel.mesh.BatchShard``)."""
    trials, stack, unstack = one_trial(hp, x.shape[0], x.device, seed,
                                       train, shard)
    logits, new_bn = apply_trials(
        stack(params), stack(bn_state), trials, x, train=train,
        row_mask=stack(row_mask), compute_dtype=compute_dtype, shard=shard)
    return logits[0], unstack(new_bn)
