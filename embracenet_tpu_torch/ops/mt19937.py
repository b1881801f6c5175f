"""A population's initial parameters drawn on the card by the MT19937 kernel
(``csrc/mt19937.cu``), bit for bit what each trial's CPU generator draws,
and its plain version.

A trial's init draws one stream: trial t seeds a CPU ``torch.Generator``
with ``seeds[t]`` and draws its leaves one after another, leaf l as
``(torch.rand(shape_l) * 2 - 1) * bound`` in float32
(``models/layers.torch_uniform_init``; ``models/layers.InitPlan`` records
the shapes and bounds).  :func:`uniform_init` returns those leaves stacked
over trials, ``[T, *shape_l]``: for the CPU from the generators themselves
(the plain version), for the card from the kernel, which runs the same
generator from the same seed, one block a trial, and writes the stacked
leaves where they are allocated.  Nothing is drawn or copied on the host
but the leaf table, the bounds and the seeds.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``embracenet_tpu_torch/_build/`` (``ops/embrace.build``) and loaded with
``ctypes``.  Its launches are the ``mt19937.launches`` counter.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from embracenet_tpu_torch.ops import embrace
from embracenet_tpu_torch.utils.profiling import count

SOURCE = Path(embrace.__file__).resolve().parents[1] / "csrc" / "mt19937.cu"
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(embrace.build(SOURCE).path))
        p = ctypes.c_void_p
        # leaves, bounds, seeds, T, n_leaves, words, stream
        lib.mt19937_uniform_init.argtypes = [p, p, p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_longlong,
                                             p]
        lib.mt19937_uniform_init.restype = ctypes.c_int
        _lib = lib
    return _lib


def uniform_init_reference(shapes, bounds, seeds) -> list:
    """Plain version: each trial's leaves from its own CPU generator, in
    order, stacked over trials (CPU tensors)."""
    out = [torch.empty((len(seeds), *s)) for s in shapes]
    for t, seed in enumerate(seeds):
        gen = torch.Generator().manual_seed(int(seed))
        for leaf, shape, bound in zip(out, shapes, bounds[t]):
            leaf[t] = (torch.rand(shape, generator=gen) * 2.0 - 1.0) * float(
                bound)
    return out


def uniform_init(shapes, bounds, seeds, device) -> list:
    """Leaf l of trial t, ``(torch.rand(shapes[l]) * 2 - 1) * bounds[t][l]``
    from trial t's generator seeded with ``seeds[t]`` (its leaves drawn in
    the order of ``shapes``), stacked over trials: ``[T, *shapes[l]]``
    float32 on ``device``.  ``bounds`` [T, L] are rounded to float32, as
    torch rounds a Python float before it multiplies a float32 tensor.  On
    the CPU the plain version; on the card the kernel, launched on the
    current stream, not waited for."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    bounds = np.asarray(bounds, np.float32).reshape(len(seeds), len(shapes))
    device = torch.device(device)
    if device.type == "cpu":
        return uniform_init_reference(shapes, bounds, seeds)
    if device.type != "cuda":
        raise ValueError(f"uniform_init: unsupported device {device}")
    out = [torch.empty((len(seeds), *s), device=device) for s in shapes]
    if not shapes:
        return out
    sizes = np.asarray([math.prod(s) for s in shapes], np.int64)
    starts = np.cumsum(sizes) - sizes
    # one copy: the leaf table [L, 3] int64 (first word, words, trial 0's
    # destination), the bounds [T, L] float32, the seeds [T] uint32
    table = np.stack([starts, sizes, [o.data_ptr() for o in out]], 1)
    seeds32 = np.asarray([int(s) & 0xFFFFFFFF for s in seeds], np.uint32)
    host = np.concatenate([a.reshape(-1).view(np.uint8) for a in
                           (table.astype(np.int64), bounds, seeds32)])
    # buf may be freed on return: the allocator hands its memory only to
    # work queued on this stream, after the kernel
    buf = torch.from_numpy(host).to(device)
    ptr = buf.data_ptr()
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mt19937_uniform_init(
            ptr, ptr + table.nbytes, ptr + table.nbytes + bounds.nbytes,
            len(seeds), len(shapes), int(sizes.sum()), stream)
    if err != 0:
        raise RuntimeError(f"mt19937_uniform_init: CUDA launch failed with "
                           f"error {err} "
                           f"({torch.cuda.get_device_name(device)})")
    count("mt19937.launches")
    return out
