"""The float32 population convolution on the card: cuDNN's grouped
convolution against the per-trial batched GEMMs over im2col windows
(``models/layers._TrialConvGemm``), phase by phase, at the CNN's four
supernet blocks.

    python3 tools/torch_conv_bench.py [--out FILE] [--trials 8]

For each block (C -> O channels at length L, 15 taps) at T trials and
B = 100 rows (a training step) and B = 200 (validation, forward only) it
prints one JSON line with the device ms of:

* ``cudnn_fwd``, ``cudnn_dgrad``, ``cudnn_wgrad``: ``F.conv1d(...,
  groups=T)`` and ``aten.convolution_backward`` for each gradient alone,
  under ``layers.exact_float32`` (deterministic algorithms, TF32 off), as
  a stacked training step runs them; ``cudnn_bwd`` both gradients in one
  call, as autograd takes them;
* ``gemm_fwd``: the GEMM path's forward (windows, product, layout), run
  at every block whatever ``layers._GEMM_MIN_DEPTH`` says;
  ``gemm_windows``: its windows alone (a pad and one gathering copy),
  ``unfold_windows``: the same by ``F.unfold``;
  ``gemm_prep``: the weight gradient's layout pass over ``dy``;
  ``gemm_wgrad``: the weight gradient from the saved windows,
  ``gemm_wgrad_regather``: the same with the windows gathered again;
  ``gemm_dgrad``: the input gradient as ``w^T @ dy`` folded back onto the
  positions (``F.fold``, the library's), ``gemm_dgrad_flip``: as ``dy``'s
  windows against the flipped weight (depth O*K);
  ``gemm_bwd``: the library's whole backward;
* ``bound_ms``: a direction's multiply-adds (2*T*B*L*O*C*K operations,
  alike for the forward and each gradient) over 67 TFLOP/s, the float32
  CUDA-core peak; each ``*_pct`` is that bound (twice it for a whole
  backward) over the phase's time;
* ``kernels``: the device kernels of cuDNN's forward and backward and of
  the GEMM path's, in launch order, from ``torch.profiler``, with each
  kernel's device ms, so the trace shows which kernel a layout transpose
  feeds.

Ends with a line naming the card (``nvidia-smi``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from embracenet_tpu_torch.benchkit import (PEAK_FLOPS, cuda_ms,  # noqa: E402
                                           nvidia_smi)
from embracenet_tpu_torch.models import layers  # noqa: E402

#: the CNN's supernet blocks: (C, O, L), 15 taps (``models/cnn.py``)
BLOCKS = ((4, 64, 256), (64, 96, 124), (96, 256, 58), (256, 512, 25))
TAPS = 15


def _randn(dev, seed, *shape):
    return torch.randn(*shape, generator=torch.Generator(device=dev)
                       .manual_seed(seed), device=dev)


def _cudnn(x, w, dy, t, mask):
    o, c, k = w.shape[1:]
    return torch.ops.aten.convolution_backward(
        dy, x, w.reshape(t * o, c, k), None, [1], [(k - 1) // 2], [1], False,
        [0], t, mask)


def _dy_layout(dy, t, o):
    b = dy.shape[0]
    return dy.reshape(b, t, o, -1).permute(1, 2, 0, 3).reshape(t, o, -1)


def _dgrad_fold(dyt, w, b, length):
    """dx as ``w^T @ dy`` folded back onto the positions (the library's)."""
    t, o, c, k = w.shape
    dcols = layers.trial_matmul(w.reshape(t, o, c * k).transpose(1, 2), dyt)
    dx = F.fold(dcols, (b, length), (1, k), padding=(0, (k - 1) // 2))
    return dx.permute(2, 0, 1, 3).reshape(b, t * c, -1)


def _dgrad_flip(dy, w, b, length):
    """dx as a convolution of dy with the flipped, transposed weight: a
    GEMM of depth O*K over dy's windows."""
    t, o, c, k = w.shape
    wflip = w.flip(-1).transpose(1, 2).reshape(t, c, o * k)
    dx = layers.trial_matmul(wflip, layers._windows(dy, t, k))
    return dx.view(t, c, b, length).permute(2, 0, 1, 3).reshape(b, t * c, -1)


def _unfold_windows(x, t, k):
    """The windows by ``F.unfold`` (im2col, one launch a trial)."""
    b, _, length = x.shape
    return F.unfold(x.view(b, t, -1, length).permute(1, 2, 0, 3), (1, k),
                    padding=(0, (k - 1) // 2))


def _kernels(fn) -> list:
    """[(kernel name, device ms)] of one call of ``fn``, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    events.sort(key=lambda e: e.start_ns())
    return [(e.name()[:96], round((e.end_ns() - e.start_ns()) / 1e6, 4))
            for e in events]


def block(dev, t, b, c, o, length, k=TAPS, backward=True) -> dict:
    x = _randn(dev, 1, b, t * c, length)
    w = _randn(dev, 2, t, o, c, k) * (c * k) ** -0.5
    dy = _randn(dev, 3, b, t * o, length)
    flops = 2 * t * b * length * o * c * k
    out = {"block": f"{c}->{o}", "T": t, "B": b, "L": length, "K": k,
           "gflop": flops / 1e9,
           "bound_ms": flops / PEAK_FLOPS[torch.float32] * 1e3}
    w2 = w.reshape(t * o, c, k)
    with layers.exact_float32():
        out["cudnn_fwd"] = cuda_ms(
            lambda: F.conv1d(x, w2, padding=(k - 1) // 2, groups=t))
        gemm_fwd = lambda: layers._TrialConvGemm.apply(x, w)  # noqa: E731
        out["gemm_fwd"] = cuda_ms(gemm_fwd)
        out["gemm_windows"] = cuda_ms(lambda: layers._windows(x, t, k))
        out["unfold_windows"] = cuda_ms(lambda: _unfold_windows(x, t, k))
        if backward:
            out["cudnn_dgrad"] = cuda_ms(
                lambda: _cudnn(x, w, dy, t, [True, False, False]))
            out["cudnn_wgrad"] = cuda_ms(
                lambda: _cudnn(x, w, dy, t, [False, True, False]))
            out["cudnn_bwd"] = cuda_ms(
                lambda: _cudnn(x, w, dy, t, [True, True, False]))
            cols = layers._windows(x, t, k)
            dyt = _dy_layout(dy, t, o)
            out["gemm_prep"] = cuda_ms(lambda: _dy_layout(dy, t, o))
            out["gemm_wgrad"] = cuda_ms(
                lambda: layers.trial_matmul(dyt, cols.transpose(1, 2)))
            out["gemm_wgrad_regather"] = cuda_ms(
                lambda: layers.trial_matmul(
                    dyt, layers._windows(x, t, k).transpose(1, 2)))
            out["gemm_dgrad"] = cuda_ms(lambda: _dgrad_fold(dyt, w, b, length))
            out["gemm_dgrad_flip"] = cuda_ms(
                lambda: _dgrad_flip(dy, w, b, length))
            xs = x.clone().requires_grad_(True)
            ws = w.clone().requires_grad_(True)
            y = layers._TrialConvGemm.apply(xs, ws)
            out["gemm_bwd"] = cuda_ms(lambda: torch.autograd.grad(
                y, (xs, ws), dy, retain_graph=True))
            # both input gradients alike within float32 rounding
            ref = _dgrad_fold(dyt, w, b, length)
            out["dgrad_flip_rel"] = float(
                (_dgrad_flip(dy, w, b, length) - ref).abs().max()
                / ref.abs().max())
            out["kernels"] = {
                "cudnn_fwd": _kernels(lambda: F.conv1d(
                    x, w2, padding=(k - 1) // 2, groups=t)),
                "cudnn_bwd": _kernels(
                    lambda: _cudnn(x, w, dy, t, [True, True, False])),
                "gemm_fwd": _kernels(gemm_fwd),
                "gemm_bwd": _kernels(lambda: torch.autograd.grad(
                    y, (xs, ws), dy, retain_graph=True))}
    for key in [k_ for k_ in out if k_.startswith(("cudnn_", "gemm_"))]:
        if isinstance(out[key], float) and key not in ("gemm_windows",
                                                       "gemm_prep"):
            # a whole backward is both gradients: twice the bound
            bound = out["bound_ms"] * (2 if key.endswith("_bwd") else 1)
            out[f"{key}_pct"] = 100 * bound / out[key]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--trials", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_bench: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lines = []
    for c, o, length in BLOCKS:
        lines.append(block(dev, args.trials, 100, c, o, length))
        lines.append(block(dev, args.trials, 200, c, o, length,
                           backward=False))
    lines.append({"device": torch.cuda.get_device_name(0),
                  "card": nvidia_smi(), "torch": torch.__version__})
    text = "\n".join(json.dumps(line) for line in lines) + "\n"
    print(text, end="", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
