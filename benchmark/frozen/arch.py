"""The two families' architecture as the benchmark reads it: the search
space's fixed sizes, one trial's flat hyperparameters (the reference's
names, as a configuration file writes them) turned into plain lists, and
the width buckets a group of trials shares.

A frozen copy: the sizes are those of the reference's search space
(``config.py``; `models/FF_net.py:18-46`, `CNN_net.py:26-57`,
`EmbraceNetMultimodal.py:124-157`, `ConcatNetMultimodal.py:42-60`), the
bucket rule the one the port's ``training/modelspec`` statics follow.
Nothing here imports the port.
"""

from __future__ import annotations

SEQ_LEN = 256
N_BASES = 4
FFNN_LAYERS = 4
FFNN_MAX_WIDTH = 256
CNN_LAYERS = 4
CNN_CHANNEL_MENUS = ((16, 32, 64), (32, 64, 96), (64, 96, 128, 256),
                     (128, 256, 512))
CNN_MAX_CHANNELS = tuple(max(m) for m in CNN_CHANNEL_MENUS)   # 64 96 256 512
CNN_KERNEL_MENU = (5, 11, 15)
CNN_MAX_KERNEL = 15
POOL_KERNEL, POOL_STRIDE = 10, 2
EMBRACE_MAX = 1024            # embracement space
EMBRACE_POST = 512            # EmbraceNet post space, 2 layers
EMBRACE_POST_LAYERS = 2
CONCAT_POST = 1024            # ConcatNet post space, 3 layers
CONCAT_POST_LAYERS = 3
MODALITY_DROPOUT_P = 0.5
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
OPTIMIZERS = {"Adam": 0, "Nadam": 1, "RMSprop": 2}
EMBRACENET, CONCATNET = "EmbraceNetMultimodal", "ConcatNetMultimodal"


def _pooled(n: int) -> int:
    return (n - POOL_KERNEL) // POOL_STRIDE + 1


#: sequence length after each conv block: 124, 58, 25, 8
CNN_LENGTHS = tuple(
    _pooled(n) for n in (SEQ_LEN, _pooled(SEQ_LEN), _pooled(_pooled(SEQ_LEN)),
                         _pooled(_pooled(_pooled(SEQ_LEN)))))
#: the CNN supernet's flatten width (64 * 124)
FLAT_MAX = max(c * n for c, n in zip(CNN_MAX_CHANNELS, CNN_LENGTHS))


def arch(model: str, flat: dict) -> dict:
    """One trial's flat hyperparameters -> plain lists of what it computes:
    live layers only (``ffnn_widths`` has ``n_layers`` entries), the
    kernels and channels of every CNN layer (fan-ins read the unused ones),
    dropout rates, the optimizer's id, lr and weight decay."""
    n_f, n_c = int(flat["FFNN_n_layers"]), int(flat["CNN_n_layers"])
    a = {
        "model": model,
        "ffnn_widths": [int(flat[f"FFNN_n_units_l{i}"]) for i in range(n_f)],
        "ffnn_dropout": [float(flat.get(f"FFNN_dropout_l{i}", 0.0)) for i in range(n_f)],
        "cnn_depth": n_c,
        "cnn_channels_all": [int(flat[f"CNN_out_channels_l{i}"])
                             for i in range(CNN_LAYERS)],
        "cnn_kernels_all": [int(flat[f"CNN_kernel_size_l{i}"])
                            for i in range(CNN_LAYERS)],
        "cnn_dropout": [float(flat.get(f"CNN_dropout_l{i}", 0.0)) for i in range(n_c)],
        "optimizer": OPTIMIZERS[flat["optimizer"]],
        "lr": float(flat["lr"]),
        "weight_decay": float(flat["weight_decay"]),
    }
    a["cnn_channels"] = a["cnn_channels_all"][:n_c]
    a["cnn_kernels"] = a["cnn_kernels_all"][:n_c]
    if model == EMBRACENET:
        n_p = int(flat["n_post_layers"])
        a["embrace"] = int(flat["EMBRACENET_embracement_size"])
        a["post_widths"] = [int(flat[f"EMBRACENET_n_units_l{i}"])
                            for i in range(n_p)]
        a["post_dropout"] = [float(flat.get(f"EMBRACENET_dropout_l{i}", 0.0))
                             for i in range(n_p)]
        a["p_ffnn"] = float(flat["selection_probabilities_FFNN"])
    elif model == CONCATNET:
        n_p = int(flat["CONCATNET_n_post_layers"])
        a["post_widths"] = [int(flat[f"CONCATNET_n_units_l{i}"])
                            for i in range(n_p)]
        a["post_dropout"] = [float(flat.get(f"CONCATNET_dropout_l{i}", 0.0))
                             for i in range(n_p)]
    else:
        raise ValueError(f"no architecture for {model}")
    return a


def ffnn_out(a: dict) -> int:
    return a["ffnn_widths"][-1]


def cnn_flat(a: dict) -> int:
    """The CNN branch's flatten width: last channels x last length."""
    return a["cnn_channels"][-1] * CNN_LENGTHS[a["cnn_depth"] - 1]


def post_space(model: str) -> int:
    return EMBRACE_POST if model == EMBRACENET else CONCAT_POST


def own_post(a: dict) -> int:
    """The post-layer bucket of a trial alone (at least 16)."""
    return max([16] + a["post_widths"])


def buckets(archs: list, width_buckets: bool) -> dict:
    """The shapes a group of trials is computed at: the FFNN width ``W``,
    per-layer CNN channels ``mc`` and taps ``mk`` (an unused layer takes
    the smallest menu entry), the CNN's depth, the flatten width ``D1``
    that the docking reads, the embracement ``EB`` and post ``PB`` spaces.
    Without width buckets every width is the supernet's."""
    model = archs[0]["model"]
    depth = max(a["cnn_depth"] for a in archs)
    if width_buckets:
        W = max(max(a["ffnn_widths"]) for a in archs)
        mc, mk = [], []
        for i in range(CNN_LAYERS):
            used = [a for a in archs if a["cnn_depth"] > i]
            mc.append(max([a["cnn_channels"][i] for a in used])
                      if used else min(CNN_CHANNEL_MENUS[i]))
            mk.append(max([a["cnn_kernels"][i] for a in used])
                      if used else min(CNN_KERNEL_MENU))
        EB = max(a.get("embrace", EMBRACE_MAX) for a in archs)
        PB = max(own_post(a) for a in archs)
    else:
        W, mc, mk = FFNN_MAX_WIDTH, list(CNN_MAX_CHANNELS), [CNN_MAX_KERNEL] * 4
        EB, PB = EMBRACE_MAX, post_space(model)
    D1 = max(mc[i] * CNN_LENGTHS[i] for i in range(depth))
    return {"W": W, "mc": mc, "mk": mk, "depth": depth, "D1": D1,
            "EB": EB, "PB": PB}
