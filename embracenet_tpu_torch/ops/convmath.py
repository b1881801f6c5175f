"""Convolution size arithmetic (reference parity).

The port's own copy of ``embracenet_tpu/ops/convmath.py``.

Mirrors `BIOINF_tesi/models/utils/utils.py:143-153` (``size_out_convolution``)
and `:178-202` (``output_size_from_model_params``).

A key structural fact exploited by the supernet design: the reference CNN
uses *same* padding for every conv (`models/CNN_net.py:39-41`), so only the
fixed ``MaxPool1d(kernel=10, stride=2)`` changes sequence length.  The length
trajectory is therefore independent of the sampled kernel size:
``256 -> 124 -> 58 -> 25 -> 8`` (wait: 25 -> floor((25-10)/2)+1 = 8).  That
makes kernel-size choice a pure weight mask and depth choice a pure gather —
both vmappable across a hyperparameter population.
"""

from __future__ import annotations

SEQ_LEN = 256
MAXPOOL_KERNEL = 10
MAXPOOL_STRIDE = 2
MAX_CNN_LAYERS = 4


def size_out_convolution(input_size: int, kernel: int, padding: int, stride: int) -> int:
    """Output length of a 1-D conv/pool (reference `utils.py:143-153`)."""
    return int((input_size + 2 * padding - kernel) / stride) + 1


def cnn_length_after(depth: int, input_size: int = SEQ_LEN) -> int:
    """Sequence length after ``depth`` conv(same-pad)+maxpool blocks."""
    size = input_size
    for _ in range(depth):
        size = size_out_convolution(size, MAXPOOL_KERNEL, 0, MAXPOOL_STRIDE)
    return size


#: Length after each block, 1-indexed by depth: depth d -> CNN_LENGTHS[d-1].
CNN_LENGTHS = tuple(cnn_length_after(d) for d in range(1, MAX_CNN_LAYERS + 1))


def output_size_from_params(n_layers: int, out_channels_last: int,
                            input_size: int = SEQ_LEN) -> int:
    """Flattened feature size ``channels * length`` after the conv stack.

    Reference parity: `models/utils/utils.py:178-202`
    (``output_size_from_model_params``); kernel size never affects it because
    of same padding.
    """
    return cnn_length_after(n_layers, input_size) * out_channels_last
