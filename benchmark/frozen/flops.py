"""Operations and bytes, and the H100's published peaks they are held to.

* The forward FLOPs of one window of a trial, at the trial's own widths
  (``bench.py``'s ``_ffnn_fwd_flops``, ``_cnn_fwd_flops`` and
  ``embrace_fwd_flops``, with a ConcatNet counterpart): 2 per
  multiply-add of every linear layer and same-padded convolution; the
  embracement itself, BatchNorm, pooling and activations are elementwise
  and not counted.
* ``bench.py``'s "useful FLOPs" rule (``report_mfu``): training a window
  costs 3 forwards, and each epoch adds one forward of every validation
  window.
* :func:`bound`, the least time of the fused docking + embracement forward
  (``benchkit.bound``): its operations over the peak of their type, or
  each input read once and each output written once over the memory
  rate, whichever is larger.

Peaks: NVIDIA's H100 SXM data sheet, dense: 67 TFLOP/s float32 on the CUDA
cores, 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, at the full
700 W power limit.
"""

from __future__ import annotations

from benchmark.frozen.arch import (CNN_LENGTHS, EMBRACENET, N_BASES, SEQ_LEN,
                                   cnn_flat, ffnn_out)

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def ffnn_fwd_flops(a: dict, in_features: int) -> float:
    flops, d_in = 0, in_features
    for w in a["ffnn_widths"]:
        flops += 2 * d_in * w
        d_in = w
    return flops


def cnn_fwd_flops(a: dict) -> float:
    flops, c_in = 0, N_BASES
    lens_in = (SEQ_LEN,) + CNN_LENGTHS
    for c, k, n in zip(a["cnn_channels"], a["cnn_kernels"], lens_in):
        flops += 2 * c_in * c * k * n       # same-pad conv at every position
        c_in = c
    return flops


def fwd_flops(a: dict, in_features: int) -> float:
    """Forward FLOPs of one window: both branches, then EmbraceNet's two
    docking layers, post layers and head, or ConcatNet's post layers on
    the concatenation and head."""
    flops = ffnn_fwd_flops(a, in_features) + cnn_fwd_flops(a)
    if a["model"] == EMBRACENET:
        flops += 2 * (ffnn_out(a) + cnn_flat(a)) * a["embrace"]
        d = a["embrace"]
    else:
        d = ffnn_out(a) + cnn_flat(a)
    for w in a["post_widths"]:
        flops += 2 * d * w
        d = w
    return flops + 2 * d * 2


def train_flops(a: dict, in_features: int, n_train: int, n_val: int,
                epochs: int = 1) -> float:
    """Useful FLOPs of fitting one trial: 3 forwards a train window and one
    a validation window, each epoch."""
    f = fwd_flops(a, in_features)
    return epochs * (3 * f * n_train + f * n_val)


def bound(T: int, B: int, D0: int, D1: int, E: int, dtype: str):
    """Least seconds of one fused forward launch over ``T`` trials of ``B``
    rows -> ``(seconds, "operations" | "bytes")``.  Operands in
    ``dtype``; biases, mask and p0 float32; ``out`` float32 and ``choose``
    one byte per element."""
    item = ITEM_BYTES[dtype]
    flops = 2.0 * T * B * (D0 + D1) * E
    nbytes = T * (item * (B * D0 + B * D1 + D0 * E + D1 * E)
                  + 4 * (3 * E + B) + 4 * B * E + B * E)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
