"""CNN_LSTM as the benchmark reads it: one trial's flat hyperparameters
(the reference's names, as a configuration file writes them) turned into
plain lists, the leaves the port draws for it in the order it draws them,
and its forward FLOPs.

A frozen copy: the sizes are the reference's (`BIOINF_tesi/models/
CNN_LSTM_net.py:9-95`: 1-2 conv blocks from the CNN's first two channel
menus, max-pool 10/2, the conv output ``[B, C, L]`` read as ``C*L/4``
steps of 4, an LSTM of 1-2 layers, then 1,000, 64 and 2 units), the init
order and bounds those of the port's ``models/cnn_lstm.init``.  Nothing
here imports the port.
"""

from __future__ import annotations

from benchmark.frozen.arch import CNN_LENGTHS, N_BASES, OPTIMIZERS, SEQ_LEN

MODEL = "CNN_LSTM"
STEP_WIDTH = 4          # inputs a timestep (CNN_LSTM_net.py:80-84)
FC1, FC2, N_CLASSES = 1000, 64, 2


def arch(flat: dict) -> dict:
    """One trial's flat hyperparameters -> its conv blocks (channels, taps,
    dropout of the live blocks), LSTM (hidden size, layers, timesteps)
    and optimizer (id, lr, weight decay)."""
    depth = int(flat["n_layers"])
    a = {
        "model": MODEL,
        "cnn_depth": depth,
        "cnn_channels": [int(flat[f"out_channels_l{i}"]) for i in range(depth)],
        "cnn_kernels": [int(flat[f"kernel_size_l{i}"]) for i in range(depth)],
        "cnn_dropout": [float(flat.get(f"dropout_l{i}", 0.0))
                        for i in range(depth)],
        "lstm_hidden": int(flat["LSTM_hidden_layer_size"]),
        "lstm_layers": int(flat["LSTM_n_layers"]),
        "optimizer": OPTIMIZERS[flat["optimizer"]],
        "lr": float(flat["lr"]),
        "weight_decay": float(flat["weight_decay"]),
    }
    flat_out = a["cnn_channels"][-1] * CNN_LENGTHS[depth - 1]
    if flat_out % STEP_WIDTH:
        raise ValueError(f"conv output {flat_out} does not split into steps "
                         f"of {STEP_WIDTH}")
    a["timesteps"] = flat_out // STEP_WIDTH
    return a


def leaves(a: dict) -> list:
    """``[(name, path, shape, fan_in)]`` of every parameter leaf, in the
    order the port's init draws them from the trial's generator: per conv
    block its weight ``[O, C, K]`` and bias (fan ``C*K``) and its
    BatchNorm's scale and bias (fan None: ones and zeros, not drawn); per
    LSTM layer ``w_ih [in, 4H]``, ``w_hh [H, 4H]``, ``b_ih``, ``b_hh``
    (fan ``H``, as torch's ``nn.LSTM``); then FC1, FC2 and the head.
    ``path`` is where the leaf sits in the port's parameter tree."""
    out, c_in = [], N_BASES
    for i, (c, k) in enumerate(zip(a["cnn_channels"], a["cnn_kernels"])):
        out += [(f"conv_w{i}", (f"conv_w{i}",), (c, c_in, k), c_in * k),
                (f"conv_b{i}", (f"conv_b{i}",), (c,), c_in * k),
                (f"bn{i}.scale", (f"bn{i}", "scale"), (c,), None),
                (f"bn{i}.bias", (f"bn{i}", "bias"), (c,), None)]
        c_in = c
    h, d_in = a["lstm_hidden"], STEP_WIDTH
    for layer in range(a["lstm_layers"]):
        for key, shape in (("w_ih", (d_in, 4 * h)), ("w_hh", (h, 4 * h)),
                           ("b_ih", (4 * h,)), ("b_hh", (4 * h,))):
            out.append((f"lstm{layer}.{key}", ("lstm", layer, key), shape, h))
        d_in = h
    flat_in = a["timesteps"] * h
    for name, rows, cols in (("fc1", flat_in, FC1), ("fc2", FC1, FC2),
                             ("head", FC2, N_CLASSES)):
        out += [(f"w_{name}", (f"w_{name}",), (rows, cols), rows),
                (f"b_{name}", (f"b_{name}",), (cols,), rows)]
    return out


def fwd_flops(a: dict) -> float:
    """Forward FLOPs of one window, 2 per multiply-add: every same-padded
    convolution at every position, the LSTM's ``2 * 4H * (in + H)`` a
    timestep a layer, FC1, FC2 and the head.  BatchNorm, pooling, gates'
    activations and biases are elementwise and not counted."""
    flops, c_in = 0, N_BASES
    for c, k, n in zip(a["cnn_channels"], a["cnn_kernels"],
                       (SEQ_LEN,) + CNN_LENGTHS):
        flops += 2 * c_in * c * k * n
        c_in = c
    h, d_in = a["lstm_hidden"], STEP_WIDTH
    for _ in range(a["lstm_layers"]):
        flops += a["timesteps"] * 2 * 4 * h * (d_in + h)
        d_in = h
    return flops + 2 * (a["timesteps"] * h * FC1 + FC1 * FC2 + FC2 * N_CLASSES)


def train_flops(a: dict, n_train: int, n_val: int, epochs: int = 1) -> float:
    """Useful FLOPs of fitting one trial, ``frozen.flops.train_flops``'s
    rule: 3 forwards a train window and one a validation window, each
    epoch."""
    f = fwd_flops(a)
    return epochs * (3 * f * n_train + f * n_val)
