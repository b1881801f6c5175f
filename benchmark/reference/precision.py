"""Where the reference rounds, and to what.

The port's precision contract (``models/layers.py``): a linear layer and
the fused docking take their operands in the compute type and accumulate
in float32; a convolution runs wholly in the compute type, its output
rounded to it.  The reference rounds at the same places, to one of:

* ``float32``: no rounding, TF32 off everywhere;
* ``bfloat16``: operands to bf16, convolution outputs to bf16;
* ``tf32``: operands to TF32's 10-bit mantissa (the control of a float32
  cell), products in float32;
* ``fp8``: operands scaled per tensor to float8 e4m3's range and rounded
  to it (the control of a bf16 cell), convolution outputs to bf16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision`` and held in float32.  A
    bf16 rounding is a cast both ways, as the port's (its gradient is
    rounded too); TF32 and fp8 round the forward value only and pass the
    gradient through unchanged."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    with torch.no_grad():
        if precision == "tf32":
            bits = x.contiguous().view(torch.int32)
            bits = (bits + 0x1000) & ~0x1FFF      # round to 10 mantissa bits
            q = bits.view(torch.float32)
        elif precision == "fp8":
            scale = x.abs().amax().clamp(min=1e-30) / _FP8_MAX
            q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            raise ValueError(f"unknown precision {precision}")
    return x + (q - x).detach() if x.requires_grad else q


def linear(x, w, b, precision: str):
    """``x @ w + b``, operands rounded, the product in float32."""
    return torch.matmul(round_to(x, precision), round_to(w, precision)) + b


def conv1d(x, w, precision: str):
    """Same-padded 1-D convolution of ``x [B, C, L]`` by ``w [O, C, K]``."""
    pad = (w.shape[-1] - 1) // 2
    if precision == "bfloat16":
        return F.conv1d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                        padding=pad).float()
    y = F.conv1d(round_to(x, precision), round_to(w, precision), padding=pad)
    return y.to(torch.bfloat16).float() if precision == "fp8" else y


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and cuDNN, deterministic cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
