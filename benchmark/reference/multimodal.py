"""Plain PyTorch EmbraceNetMultimodal and ConcatNetMultimodal, one trial at
its own widths, for the benchmark's comparisons.

It follows the reference's layer equations (`BIOINF_tesi/models/
FF_net.py`, `CNN_net.py`, `EmbraceNetMultimodal.py`,
`ConcatNetMultimodal.py`) as the port states them:

* FFNN branch: per layer ``relu(x @ w + b)`` then inverted dropout;
* CNN branch on the one-hot sequence: per block a same-padded convolution
  plus bias, BatchNorm (batch moments over the unmasked rows while
  training, running ones in evaluation), ReLU, max-pool (10, 2), inverted
  dropout; then the channel-major flatten;
* EmbraceNet: modality dropout while training (a coin at 0.5, then one
  modality a row), docking ``relu(x_i @ w_i + b_i)`` of both branches, and
  per (row, feature) modality 0 where the embracement's uniform is below
  the row's normalised selection probability; 0-2 post layers with
  dropout; a linear head;
* ConcatNet: the branches' features concatenated, 1-3 post layers with
  dropout, a linear head.

There are no masks, buckets or trial axes: each leaf holds only what the
trial reads.  The random draws are worked out again, not taken from the
port: the dropout uniforms from the trial's step generator in the order
and at the shapes a fit of the trial draws them, the embracement's from
:func:`benchmark.frozen.philox.philox_uniform` on the card (or, for the
port's CPU path, a CPU ``torch.Generator``).  The initial parameters are
drawn as the port's ``init_from_fans`` draws them, from the trial's init
seed, and cut to the live blocks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.frozen.arch import (BN_EPS, CNN_LAYERS, CNN_LENGTHS,
                                   CNN_MAX_CHANNELS, CNN_MAX_KERNEL,
                                   EMBRACE_MAX, EMBRACE_POST_LAYERS,
                                   CONCAT_POST_LAYERS, EMBRACENET,
                                   FFNN_LAYERS, FFNN_MAX_WIDTH, FLAT_MAX,
                                   MODALITY_DROPOUT_P, N_BASES, cnn_flat,
                                   ffnn_out, post_space)
from benchmark.frozen.philox import philox_uniform
from benchmark.reference.precision import conv1d, linear


# --------------------------------------------------------------------------
# layouts: the supernet's full leaves, and where a trial's live block sits
# --------------------------------------------------------------------------

def full_layout(a: dict, in_features: int):
    """``[(name, shape, fan_in)]`` of every drawn leaf, in the order the
    port's ``init_from_fans`` draws them (BatchNorm's scale and bias are
    ones and zeros, not drawn)."""
    fans, fan = [], in_features
    for i in range(FFNN_LAYERS):
        fans.append(fan)
        if i < len(a["ffnn_widths"]):
            fan = a["ffnn_widths"][i]
    out = []
    for i in range(FFNN_LAYERS):
        out.append((f"ffnn.w{i}", (in_features if i == 0 else FFNN_MAX_WIDTH,
                                   FFNN_MAX_WIDTH), fans[i]))
        out.append((f"ffnn.b{i}", (FFNN_MAX_WIDTH,), fans[i]))
    c_in = N_BASES
    for i in range(CNN_LAYERS):
        fan = c_in * a["cnn_kernels_all"][i]
        c_max_in = N_BASES if i == 0 else CNN_MAX_CHANNELS[i - 1]
        out.append((f"cnn.conv_w{i}", (CNN_MAX_CHANNELS[i], c_max_in,
                                       CNN_MAX_KERNEL), fan))
        out.append((f"cnn.conv_b{i}", (CNN_MAX_CHANNELS[i],), fan))
        if i < a["cnn_depth"]:
            c_in = a["cnn_channels"][i]
    P = post_space(a["model"])
    if a["model"] == EMBRACENET:
        e = a["embrace"]
        out += [("dock0_w", (FFNN_MAX_WIDTH, EMBRACE_MAX), ffnn_out(a)),
                ("dock0_b", (EMBRACE_MAX,), ffnn_out(a)),
                ("dock1_w", (FLAT_MAX, EMBRACE_MAX), cnn_flat(a)),
                ("dock1_b", (EMBRACE_MAX,), cnn_flat(a))]
        fan, n_layers, first_in = e, EMBRACE_POST_LAYERS, EMBRACE_MAX
    else:
        fan, n_layers = ffnn_out(a) + cnn_flat(a), CONCAT_POST_LAYERS
        first_in = FFNN_MAX_WIDTH + FLAT_MAX
    for i in range(n_layers):
        out.append((f"post_w{i}", (first_in if i == 0 else P, P), fan))
        out.append((f"post_b{i}", (P,), fan))
        if i < len(a["post_widths"]):
            fan = a["post_widths"][i]
    head_rows = EMBRACE_MAX + P if a["model"] == EMBRACENET else P
    out += [("head_w", (head_rows, 2), fan), ("head_b", (2,), fan)]
    return out


def live_blocks(a: dict, bk: dict) -> dict:
    """name -> ``(leaf path, index)``: where each of the trial's live blocks
    sits in a leaf laid out at the bucket ``bk`` (``frozen.arch.buckets``;
    the supernet's full layout is the bucket of full widths).  A ConcatNet
    ``post_w0`` index is a pair of row ranges, joined."""
    fw, n_f = a["ffnn_widths"], len(a["ffnn_widths"])
    out = {}
    for i in range(n_f):
        rows = slice(None) if i == 0 else slice(0, fw[i - 1])
        out[f"ffnn.w{i}"] = (("ffnn", f"w{i}"), (rows, slice(0, fw[i])))
        out[f"ffnn.b{i}"] = (("ffnn", f"b{i}"), (slice(0, fw[i]),))
    ch, ks = a["cnn_channels"], a["cnn_kernels"]
    for i in range(a["cnn_depth"]):
        c_in = N_BASES if i == 0 else ch[i - 1]
        lo = (CNN_MAX_KERNEL - ks[i]) // 2
        out[f"cnn.conv_w{i}"] = (("cnn", f"conv_w{i}"),
                                 (slice(0, ch[i]), slice(0, c_in),
                                  slice(lo, lo + ks[i])))
        out[f"cnn.conv_b{i}"] = (("cnn", f"conv_b{i}"), (slice(0, ch[i]),))
        for k in ("scale", "bias"):
            out[f"cnn.bn{i}.{k}"] = (("cnn", f"bn{i}", k), (slice(0, ch[i]),))
    pw = a["post_widths"]
    if a["model"] == EMBRACENET:
        e = a["embrace"]
        out["dock0_w"] = (("dock0_w",), (slice(0, ffnn_out(a)), slice(0, e)))
        out["dock0_b"] = (("dock0_b",), (slice(0, e),))
        out["dock1_w"] = (("dock1_w",), (slice(0, cnn_flat(a)), slice(0, e)))
        out["dock1_b"] = (("dock1_b",), (slice(0, e),))
        first_rows = slice(0, e)
        # the head's rows are the [EB | PB] concatenation's
        head_rows = slice(bk["EB"], bk["EB"] + pw[-1]) if pw else slice(0, e)
    else:
        # post_w0's rows are the [W | flatten] concatenation's
        first_rows = ((0, ffnn_out(a)), (bk["W"], bk["W"] + cnn_flat(a)))
        head_rows = slice(0, pw[-1])
    for i, w in enumerate(pw):
        rows = first_rows if i == 0 else slice(0, pw[i - 1])
        out[f"post_w{i}"] = ((f"post_w{i}",), (rows, slice(0, w)))
        out[f"post_b{i}"] = ((f"post_b{i}",), (slice(0, w),))
    out["head_w"] = (("head_w",), (head_rows, slice(None)))
    out["head_b"] = (("head_b",), (slice(None),))
    return out


def full_bucket(a: dict) -> dict:
    return {"W": FFNN_MAX_WIDTH, "EB": EMBRACE_MAX, "PB": post_space(a["model"])}


def take(leaf: torch.Tensor, index) -> torch.Tensor:
    """The block ``index`` (from :func:`live_blocks`) of ``leaf``; leading
    axes beyond the index (a trial axis) are kept."""
    lead = (slice(None),) * (leaf.dim() - len(index))
    first = index[0]
    if isinstance(first, tuple):                # rows from two ranges
        parts = [leaf[lead + (slice(lo, hi),) + tuple(index[1:])]
                 for lo, hi in first]
        return torch.cat(parts, dim=len(lead))
    return leaf[lead + tuple(index)]


def get_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def live_leaves(tree, a: dict, bk: dict) -> dict:
    """The trial's live blocks of a params tree laid out at ``bk``."""
    return {name: take(get_path(tree, path), idx)
            for name, (path, idx) in live_blocks(a, bk).items()}


def init_trial(a: dict, seed: int, in_features: int) -> dict:
    """The trial's initial live leaves: every full-layout leaf drawn in the
    port's order from a CPU generator seeded with ``seed`` as
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BatchNorm scale 1 and bias 0, then
    cut to the live blocks (float32, on the CPU)."""
    gen = torch.Generator().manual_seed(int(seed))
    tree: dict = {}
    for name, shape, fan in full_layout(a, in_features):
        bound = 1.0 / max(float(np.float32(fan)), 1.0) ** 0.5
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (u * 2.0 - 1.0) * bound
    for i in range(CNN_LAYERS):
        c = CNN_MAX_CHANNELS[i]
        tree["cnn"][f"bn{i}"] = {"scale": torch.ones(c), "bias": torch.zeros(c)}
    return live_leaves(tree, a, full_bucket(a))


# --------------------------------------------------------------------------
# draws
# --------------------------------------------------------------------------

class StepDraws:
    """A trial's draws of one training step, from its step generator, at
    the shapes a fit of it alone draws: its own width bucket where the fit
    has width buckets, the supernet's otherwise."""

    def __init__(self, a: dict, seed: int, rows: int, width_buckets: bool,
                 device):
        self.gen = torch.Generator(device).manual_seed(int(seed))
        self.a, self.rows, self.wb, self.dev = a, rows, width_buckets, device

    def _rand(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.dev)

    def ffnn(self, i):
        own = max(self.a["ffnn_widths"]) if self.wb else FFNN_MAX_WIDTH
        return self._rand((self.rows, own))[:, :self.a["ffnn_widths"][i]]

    def cnn(self, i):
        c = self.a["cnn_channels"][i]
        own = c if self.wb else CNN_MAX_CHANNELS[i]
        return self._rand((self.rows, own, CNN_LENGTHS[i]))[:, :c]

    def modality(self):
        coin = self._rand(())
        return coin, self._rand((self.rows,))

    def kernel_key(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.gen,
                                 device=self.dev))

    def post(self, i):
        own = (max([16] + self.a["post_widths"]) if self.wb
               else post_space(self.a["model"]))
        return self._rand((self.rows, own))[:, :self.a["post_widths"][i]]


def embrace_uniforms(key: int, rows: int, cols: int, device,
                     cpu_draw: bool = False) -> torch.Tensor:
    """The embracement's ``[rows, cols]`` uniforms for key ``key``: the
    kernel's Philox draw, or with ``cpu_draw`` the port's CPU path (rows of
    a CPU ``torch.Generator`` seeded with the key, at the live width)."""
    if cpu_draw:
        return torch.rand((rows, cols), generator=torch.Generator()
                          .manual_seed(int(key))).to(device)
    return torch.from_numpy(_philox(int(key), rows, cols)).to(device)


@functools.lru_cache(maxsize=2)
def _philox(key: int, rows: int, cols: int):
    """The kernel's draw, kept: serving keys every micro-batch alike."""
    return philox_uniform(key, rows, cols)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _dropout(x, rate: float, u):
    keep = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(
        rate, dtype=torch.float32)
    keep = keep.to(x.device)
    return torch.where(u < keep, x / torch.clamp(keep, min=1e-8),
                       torch.zeros_like(x))


def _batchnorm(z, scale, bias, mask, stats=None):
    """BatchNorm1d over ``z [B, C, L]``: moments over the rows where
    ``mask`` is 1 (training), or the running ``stats`` (evaluation)."""
    if stats is not None:
        y = (z - stats["mean"][None, :, None]) * torch.rsqrt(
            stats["var"] + BN_EPS)[None, :, None]
    else:
        m = mask[:, None, None]
        n = torch.clamp(mask.sum() * z.shape[-1], min=1.0)
        mean = (z * m).sum(dim=(0, 2)) / n
        var = (((z - mean[None, :, None]) ** 2) * m).sum(dim=(0, 2)) / n
        y = (z - mean[None, :, None]) * torch.rsqrt(var + BN_EPS)[None, :, None]
    return y * scale[None, :, None] + bias[None, :, None]


def forward(a: dict, P: dict, x, codes, mask, precision: str, draws=None,
            bn_stats=None, eval_key: int = 0, cpu_draw: bool = False):
    """Logits ``[B, 2]`` of one trial.  Training when ``draws`` (a
    :class:`StepDraws`) is given; otherwise evaluation with BatchNorm's
    running ``bn_stats`` (``{i: {"mean", "var"}}``) and the embracement
    keyed by ``eval_key``."""
    train = draws is not None
    h = x
    for i, w in enumerate(a["ffnn_widths"]):
        h = torch.relu(linear(h, P[f"ffnn.w{i}"], P[f"ffnn.b{i}"], precision))
        if train:
            h = _dropout(h, a["ffnn_dropout"][i], draws.ffnn(i))
    f_ffnn = h

    z = F.one_hot(codes.long(), N_BASES).transpose(1, 2).float()  # [B, 4, L]
    for i in range(a["cnn_depth"]):
        z = conv1d(z, P[f"cnn.conv_w{i}"], precision) \
            + P[f"cnn.conv_b{i}"][None, :, None]
        z = _batchnorm(z, P[f"cnn.bn{i}.scale"], P[f"cnn.bn{i}.bias"], mask,
                       None if train else bn_stats[i])
        z = F.max_pool1d(torch.relu(z), kernel_size=10, stride=2)
        if train:
            z = _dropout(z, a["cnn_dropout"][i], draws.cnn(i))
    f_cnn = z.reshape(z.shape[0], -1)
    rows = x.shape[0]

    if a["model"] == EMBRACENET:
        p0 = torch.tensor(a["p_ffnn"], dtype=torch.float32)
        p1 = torch.tensor(1.0 - float(p0), dtype=torch.float32)
        pa = torch.stack([p0, p1]).to(x.device).expand(rows, 2)
        if train:
            coin, target = draws.modality()
            avail = F.one_hot(torch.round(target).long(), 2).float()
            if float(coin) >= MODALITY_DROPOUT_P:
                pa = pa * avail
            key = draws.kernel_key()
        else:
            key = eval_key
        p_row = pa[:, 0] / torch.clamp(pa.sum(-1), min=1e-30)
        e = a["embrace"]
        u = embrace_uniforms(key, rows, e, x.device, cpu_draw)
        d0 = torch.relu(linear(f_ffnn, P["dock0_w"], P["dock0_b"], precision))
        d1 = torch.relu(linear(f_cnn, P["dock1_w"], P["dock1_b"], precision))
        h = torch.where(u < p_row[:, None], d0, d1)
    else:
        h = torch.cat([f_ffnn, f_cnn], dim=-1)
    for i in range(len(a["post_widths"])):
        h = torch.relu(linear(h, P[f"post_w{i}"], P[f"post_b{i}"], precision))
        if train:
            h = _dropout(h, a["post_dropout"][i], draws.post(i))
    return linear(h, P["head_w"], P["head_b"], precision)


def weighted_cross_entropy(logits, y, mask):
    """The reference's per-batch INS-weighted cross entropy over the
    unmasked rows: class weights ``1/count`` normalised over both classes,
    ``sum w nll / sum w``."""
    yf = y.float()
    pos, neg = (yf * mask).sum(), ((1 - yf) * mask).sum()
    pos_inv = torch.where(pos > 0, 1.0 / torch.clamp(pos, min=1.0), 0.0)
    neg_inv = torch.where(neg > 0, 1.0 / torch.clamp(neg, min=1.0), 0.0)
    denom = torch.clamp(pos_inv + neg_inv, min=1e-30)
    w = torch.where(y == 1, pos_inv / denom, neg_inv / denom) * mask
    nll = -torch.log_softmax(logits.float(), -1).gather(-1, y[:, None].long())[:, 0]
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-30)
