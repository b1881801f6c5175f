"""Masked building blocks for architecture supernets (port of
``embracenet_tpu/models/layers.py``).

Every tunable architecture lives inside a fixed maximal shape: width menus
become feature masks, the kernel-size menu a centered tap mask over the
maximal kernel, and depth a pass-through selection.  Layouts follow the JAX
package: ``linear`` is ``x @ w`` with ``w[in, out]``, ``conv1d_ncw`` takes
``x[B, C, L]`` and ``w[O, I, K]``.

Precision contract (as ``layers.py:65-98`` of the JAX package):

  * ``compute_dtype=None``: true float32.  Matrix products run at
    ``float32_matmul_precision("highest")`` and cuDNN convolutions with TF32
    off (cuDNN's default would round inputs to TF32's 10-bit mantissa).
  * ``compute_dtype=bfloat16``: ``linear`` rounds its operands to bf16 and
    accumulates in float32; ``conv1d_ncw`` runs wholly in bf16 and the
    result is upcast afterwards.

Initialisation parity: torch ``nn.Linear``/``nn.Conv1d`` default init is
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases; supernet
sub-blocks use the trial's *actual* fan-in.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def as_dtype(compute_dtype) -> torch.dtype | None:
    """``None`` | a dtype name | a torch dtype -> the low-precision torch
    dtype, or None for the full float32 path (float32 itself included)."""
    if compute_dtype is not None and not isinstance(compute_dtype, torch.dtype):
        compute_dtype = getattr(torch, str(compute_dtype))
    return None if compute_dtype == torch.float32 else compute_dtype


@contextlib.contextmanager
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def torch_uniform_init(generator: torch.Generator, shape, fan_in) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch Linear/Conv1d default."""
    bound = 1.0 / max(float(fan_in), 1.0) ** 0.5
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * 2.0 - 1.0) * bound


def width_mask(max_width: int, width, device=None) -> torch.Tensor:
    """[max_width] float mask with ones below ``width``."""
    return (torch.arange(max_width, device=device) < int(width)).float()


def kernel_tap_mask(max_kernel: int, kernel, device=None) -> torch.Tensor:
    """Centered tap mask: a same-padded conv with ``max_kernel`` taps whose
    mask keeps the centered ``kernel`` taps computes exactly a same-padded
    ``kernel``-tap conv (both paddings are symmetric for odd sizes)."""
    idx = torch.arange(max_kernel, device=device)
    lo = (max_kernel - int(kernel)) // 2
    return ((idx >= lo) & (idx < lo + int(kernel))).float()


def dropout(x: torch.Tensor, rate, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """Inverted dropout, torch semantics, drawn from ``generator`` (a
    ``torch.Generator`` on ``x``'s device)."""
    if not train:
        return x
    keep = 1.0 - float(rate)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / max(keep, 1e-8), torch.zeros_like(x))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """y = x @ w + b with the precision contract of the module docstring.

    In bf16 mode the operands are rounded to bf16 and the product is taken
    in float32: a bf16 x bf16 product is exact in float32, so this is bf16
    operands with float32 accumulation, the JAX
    ``preferred_element_type=float32`` form."""
    dt = as_dtype(compute_dtype)
    if dt is not None:
        x = x.to(dt).float()
        w = w.to(dt).float()
    with _highest_matmul_precision():
        # w.to(x.dtype): bf16 live weights (TrainConfig.param_dtype) promote
        # to float32, as JAX promotes a mixed product
        return torch.matmul(x, w.to(x.dtype)) + b


def conv1d_ncw(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Same-padded 1-D conv, NCW layout (x: [B,C,L], w: [O,I,K])."""
    pad = (w.shape[-1] - 1) // 2
    dt = as_dtype(compute_dtype)
    if dt is not None:
        return F.conv1d(x.to(dt), w.to(dt), padding=pad).float()
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        return F.conv1d(x, w.to(x.dtype), padding=pad)


def maxpool1d(x: torch.Tensor, kernel: int = 10, stride: int = 2) -> torch.Tensor:
    """torch MaxPool1d(kernel, stride), floor mode. x: [B, C, L]."""
    return F.max_pool1d(x, kernel_size=kernel, stride=stride)


# ---------------------------------------------------------------------------
# BatchNorm1d with torch semantics + padding-row masking
# ---------------------------------------------------------------------------

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batchnorm_init(n_channels: int):
    params = {"scale": torch.ones(n_channels), "bias": torch.zeros(n_channels)}
    state = {"mean": torch.zeros(n_channels), "var": torch.ones(n_channels)}
    return params, state


def batchnorm_apply(x, params, state, train: bool, row_mask=None):
    """BatchNorm1d over [B, C, L] (stats over B and L per channel).

    ``row_mask`` ([B]) excludes padded rows from the batch statistics so a
    padded static batch normalises identically to a ragged one.  Running
    stats use the unbiased variance, torch-style.  Returns (y, new_state).
    """
    scale = params["scale"][None, :, None]
    bias = params["bias"][None, :, None]
    if not train:
        mean, var = state["mean"], state["var"]
        inv = torch.rsqrt(var + BN_EPS)
        y = (x - mean[None, :, None]) * inv[None, :, None]
        return y * scale + bias, state

    if row_mask is None:
        row_mask = torch.ones(x.shape[0], device=x.device)
    m = row_mask.float()[:, None, None]
    n = torch.clamp(m.sum() * x.shape[-1], min=1.0)
    mean = (x * m).sum(dim=(0, 2)) / n
    var = (((x - mean[None, :, None]) ** 2) * m).sum(dim=(0, 2)) / n
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean[None, :, None]) * inv[None, :, None]
    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
    new_state = {
        "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
        "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
    }
    return y * scale + bias, new_state
