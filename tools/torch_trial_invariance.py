"""Whether the card's library calls sum a trial alike in populations of any
size: the condition under which a trial of a stacked population equals its
fit alone bit for bit.

    python3 tools/torch_trial_invariance.py [--out FILE]

For each operation of a stacked training step that mixes a trial's own
values, it computes trial 0's result (forward and gradients) in
populations of T = 1, 2, 3, 8 and 9 trials and prints, per T, whether it
equals T = 2's bit for bit:

* ``bmm``: the batched float32 product ``torch.matmul`` of ``[T, 100,
  7936] @ [T, 7936, 1024]`` (the docking product at the widest width) and
  of ``[T, 100, 256] @ [T, 256, 256]``, with both gradients, at
  ``float32_matmul_precision("highest")``;
* ``conv``: the grouped convolution of ``[100, T*64, 124]`` with ``[T,
  96, 64, 15]`` (``groups=T``, the CNN's second block) under
  ``cudnn.flags(deterministic=True, allow_tf32=False)``, both gradients;
* ``bn_sum``, ``row_sum``: the reductions of a BatchNorm's moments
  (``[100, T, 96, 124]`` over rows and length) and of a loss (``[T,
  100]`` over rows).

Prints one JSON line with the card's ``nvidia-smi`` name and power limit.
Needs a CUDA card.
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

from embracenet_tpu_torch.benchkit import nvidia_smi  # noqa: E402
from embracenet_tpu_torch.models.layers import (conv1d_trials,  # noqa: E402
                                                exact_float32,
                                                population_invariant)

COUNTS = (1, 2, 3, 8, 9)


def _randn(dev, seed, *shape):
    return torch.randn(*shape, generator=torch.Generator(device=dev)
                       .manual_seed(seed), device=dev)


def _same_as_two(fn) -> dict:
    """{T: trial 0's results at T equal those at T = 2, bit for bit}."""
    got = {t: fn(t) for t in COUNTS}
    return {t: all(torch.equal(a, b) for a, b in zip(got[t], got[2]))
            for t in COUNTS}


def bmm(dev, b, k, n):
    x, w, g = (_randn(dev, 1, 9, b, k), _randn(dev, 2, 9, k, n),
               _randn(dev, 3, 9, b, n))

    def trial0(t):
        xs, ws = (a[:t].clone().requires_grad_(True) for a in (x, w))
        with exact_float32():
            y = torch.matmul(xs, ws)
            gx, gw = torch.autograd.grad(y, (xs, ws), g[:t])
        return y[0], gx[0], gw[0]

    return _same_as_two(trial0)


def conv(dev, c=64, o=96, length=124, k=15, library=False):
    """cuDNN's grouped convolution, or with ``library`` the port's
    ``conv1d_trials`` as ``engine.fit`` runs it."""
    x, w = _randn(dev, 4, 100, 9 * c, length), _randn(dev, 5, 9, o, c, k)
    g = _randn(dev, 6, 100, 9 * o, length)

    def trial0(t):
        xs = x[:, :t * c].clone().requires_grad_(True)
        ws = w[:t].clone().requires_grad_(True)
        with exact_float32(), population_invariant():
            y = (conv1d_trials(xs, ws) if library else F.conv1d(
                xs, ws.reshape(t * o, c, k), padding=k // 2, groups=t))
            gx, gw = torch.autograd.grad(y, (xs, ws), g[:, :t * o])
        return y[:, :o], gx[:, :c], gw[0]

    return _same_as_two(trial0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trial_invariance: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    moments = _randn(dev, 7, 100, 9, 96, 124)
    losses = _randn(dev, 8, 9, 100)
    line = {"bmm_100x7936x1024": bmm(dev, 100, 7936, 1024),
            "bmm_100x256x256": bmm(dev, 100, 256, 256),
            "conv_64_to_96": conv(dev),
            **{f"conv1d_trials_{c}_to_{o}": conv(dev, c, o, length,
                                                 library=True)
               for c, o, length in ((4, 64, 256), (64, 96, 124),
                                    (96, 256, 58), (256, 512, 25))},
            "bn_sum": _same_as_two(
                lambda t: [moments[:, :t].sum(dim=(0, 3))[0]]),
            "row_sum": _same_as_two(lambda t: [losses[:t].sum(-1)[0]]),
            "device": torch.cuda.get_device_name(0), "card": nvidia_smi()}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
