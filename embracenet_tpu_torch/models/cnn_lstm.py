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

from embracenet_tpu_torch.models.layers import (
    batchnorm_apply,
    batchnorm_init,
    conv1d_ncw,
    dropout as _dropout,
    exact_float32,
    linear,
    maxpool1d,
    torch_uniform_init,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS


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


def lstm_apply(params, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """x: [B, T, D] -> outputs [B, T, H] of the stacked LSTM (batch first,
    zero initial state), as calls of torch's LSTM: cuDNN's on the card
    (with TF32 off), in chunks of rows that bound one call's workspace
    (:data:`LSTM_CHUNK`; rows are independent), and ATen's on the CPU, in
    one call.  ``train`` keeps what the backward pass needs."""
    hidden = params[0]["w_hh"].shape[0]
    flat = []
    for lp in params:   # torch's layout: w_ih [4H, in], w_hh [4H, H]
        flat += [lp["w_ih"].to(x.dtype).t().contiguous(),
                 lp["w_hh"].to(x.dtype).t().contiguous(),
                 lp["b_ih"].to(x.dtype), lp["b_hh"].to(x.dtype)]
    rows = (max(1, LSTM_CHUNK // (x.shape[1] * 4 * hidden * len(params)))
            if x.is_cuda else len(x))
    outs = []
    with exact_float32():
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


def apply(params, bn_state, hp, x, *, train: bool = False, seed: int = 0,
          row_mask=None, compute_dtype=None, shard=None):
    """x: one-hot [B, 4, 256] -> (logits [B, 2], new_bn_state); ``shard``:
    this rank's rows of a data-sharded batch (``parallel.mesh.BatchShard``)."""
    depth = int(hp["n_layers"])
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    new_bn = dict(bn_state)
    h = x
    for i in range(depth):
        z = conv1d_ncw(h, params[f"conv_w{i}"], compute_dtype) \
            + params[f"conv_b{i}"][None, :, None]
        z, new_bn[f"bn{i}"] = batchnorm_apply(z, params[f"bn{i}"],
                                              bn_state[f"bn{i}"], train, row_mask,
                                              shard)
        z = maxpool1d(torch.relu(z))
        h = _dropout(z, hp["dropout"][i], gen, train, shard)
    b = h.shape[0]
    seq = h.contiguous().reshape(b, -1, 4)   # [B, C*L/4, 4] (reference :84)
    out = lstm_apply(params["lstm"], seq, train)
    z = linear(out.reshape(b, -1), params["w_fc1"], params["b_fc1"])
    z = linear(z, params["w_fc2"], params["b_fc2"])
    return linear(z, params["w_head"], params["b_head"]), new_bn
