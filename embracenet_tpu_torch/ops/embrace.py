"""Fused EmbraceNet docking + stochastic embracement.

Port of the Pallas TPU kernels of ``embracenet_tpu/ops/pallas/embrace.py``
(``_kernel`` behind ``fused_embrace``, and its full-E variant
``_kernel_fulle`` behind ``_fused_fwd_fulle``).  Both docking matmuls, the
ReLU, the per-(row, feature) Bernoulli draw and the select run in one CUDA
kernel written for Hopper (``csrc/embrace.cu``), so the ``[B, E]`` docking
activations never reach device memory.

* :func:`fused_embrace` is differentiable (:class:`FusedEmbrace`, the
  counterpart of the JAX custom VJP).  Its forward is the tiled kernel on a
  CUDA tensor (TMA-fed ``wgmma`` for bf16 operands, a float32 FMA mainloop
  for float32 ones, K split across a thread-block cluster where the output
  tiles alone would leave the card idle: :func:`launch_plan`) and
  :func:`fused_embrace_reference` with uniforms from a ``torch.Generator``
  seeded with ``seed`` on a CPU tensor; its backward is the JAX ``_bwd``:
  masked products in float32, which JAX left to XLA and which stay
  ``torch.matmul`` (cuBLAS on the card) here.
* :func:`fused_embrace_fulle` is the full-E kernel, forward only as in JAX:
  the tiled kernel's mainloop and epilogue under a thread-block cluster
  that spans E (:func:`fulle_plan`), each CTA owning one 128-feature column
  tile and walking all of K, each x tile multicast by TMA to every CTA of
  the cluster, so x is read once per cluster rather than once per column
  tile.  It computes the same function and draws the same Philox stream,
  so for the same seed both kernels choose identically, bit for bit (the
  TPU reseeded per B-block, ``seed + i``, so its two kernels did not);
  ``out`` is equal bit for bit where both plans take the same tile rows and
  the tiled one splits no K, and within rounding elsewhere.
* :func:`fused_embrace_reference` is the plain PyTorch version with the
  uniforms ``u`` given: the tests and ``chip_smoke.py`` hold both kernels
  against it.
* the counters ``embrace.launches`` and ``embrace.launches_fulle``
  (``utils.profiling.counters``) count kernel launches, so a run can show
  that its path went through the kernel.

Both take a population: with a leading trial axis (x0 ``[T, B, D0]``, x1
``[T, B, D1]``, w0 ``[T, D0, E]``, w1 ``[T, D1, E]``, b0, b1, e_mask
``[T, E]``, p0 ``[T, B]``, one seed per trial) one launch computes every
trial, as Pallas' batching rule runs ``_kernel`` under the JAX engine's
``jax.vmap``: the trial index is part of the kernel's grid, and trial t
draws from its own seed, so its ``choose`` is bit for bit that of a launch
on its operands alone.  Without the axis (2-D operands) a call is one
trial, as before.

Stated divergences from the TPU kernels: the draw is Philox4x32-10 keyed by
``seed`` with counter (row, feature), not the TPU's PRNG (same
distribution, different stream); and the operands keep the dtype the caller
gives (float32 or bfloat16, following ``compute_dtype``) where the TPU
wrapper always cast them to bfloat16.

``seed`` is an int or a 0-d int64 tensor on the operands' device (every
trial keyed alike), or with a trial axis a ``[T]`` int64 tensor of keys;
the kernels read a tensor seed from device memory, so a seed drawn on the
card never waits for the host.  ``row_base`` (0 by default) offsets the row of
every draw: a launch on rows ``[r, r + b)`` of a batch, with ``row_base =
r``, draws Philox (seed, r + i, c) for its row i, as the launch on the whole
batch draws for that row (a data-sharded fit's shard, ``parallel/mesh.py``).

Both kernels read their operands with TMA, which needs each base
16-byte aligned and each row stride a multiple of 16 bytes
(:func:`tma_problem`).  The model's operands meet this, except x0 with a
row of 4 bf16 values (the FFNN's narrowest last layer): :func:`tma_x0`
copies that small ``[B, D0]`` tensor into a zero-padded one.  Any other
operand TMA cannot read raises ``ValueError``; none is copied silently.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``embracenet_tpu_torch/_build/`` (a shared library with a plain C
interface, loaded with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from embracenet_tpu_torch.utils.profiling import count

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "embrace.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


class Built(NamedTuple):
    """A kernel file's shared library, what its nvcc run printed (ptxas'
    registers and spills) and that run's seconds (0.0 where the library was
    already built)."""
    path: Path
    log: str
    seconds: float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from csrc/*.cu with the CUDA toolkit")
    return path


def build(source: Path = SOURCE) -> Built:
    """Compile ``source`` (``csrc/embrace.cu`` unless another of the port's
    kernel files is named; once per source content) into
    ``_build/lib<stem>_<tag>.so``, its nvcc output kept beside it as
    ``.log``, and return both with the build's seconds."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return Built(lib, log.read_text() if log.exists() else "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    return Built(lib, text, seconds)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # dtype, (x0, x1, w0, w1: pointer, row stride, trial stride), b0,
        # b1, p0, e_mask, out, choose, T, B, D0, D1, E, seed, seed_dev,
        # row_base, stream
        common = [i32] + [p, i64, i64] * 4 + [p] * 6 + [i32] * 5 + [
            ctypes.c_uint, p, i32, p]
        lib.embrace_fused_fwd.argtypes = common + [i32, i32]   # bm, split
        lib.embrace_fused_fwd_fulle.argtypes = common + [i32, i32]   # bm, cluster
        lib.embrace_fused_fwd_clusters.argtypes = [i32] * 6
        lib.embrace_fused_fwd_clusters.restype = i32
        for fn in (lib.embrace_fused_fwd, lib.embrace_fused_fwd_fulle):
            fn.restype = i32
        _lib = lib
    return _lib


def fused_embrace_reference(x0, x1, w0, b0, w1, b1, p0, e_mask, u):
    """Plain PyTorch version: ``(out, choose)`` with ``out = where(u <
    p0[:, None], relu(x0 @ w0 + b0), relu(x1 @ w1 + b1)) * e_mask`` and
    ``choose`` as uint8, per trial where the operands have a trial axis
    (``u [T, B, E]``).  Operands are upcast to float32 (bf16 operands are
    exact there), products taken at full float32 precision."""
    from embracenet_tpu_torch.models.layers import linear

    d0 = torch.relu(linear(x0.float(), w0.float(), b0))
    d1 = torch.relu(linear(x1.float(), w1.float(), b1))
    pick0 = u < p0[..., None]
    return (torch.where(pick0, d0, d1) * e_mask.unsqueeze(-2),
            pick0.to(torch.uint8))


def _check(x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base=0):
    """Raises on operands the entries do not take; all have a leading
    trial axis of T here."""
    dev = x0.device
    if x0.dim() != 3:
        raise ValueError(f"fused_embrace: x0 must be [B, D0] or [T, B, D0], "
                         f"got {tuple(x0.shape)}")
    n, b, d0 = x0.shape
    d1, e = x1.shape[-1], w0.shape[-1]
    for name, t, shape in (("x0", x0, (n, b, d0)), ("x1", x1, (n, b, d1)),
                           ("w0", w0, (n, d0, e)), ("w1", w1, (n, d1, e)),
                           ("b0", b0, (n, e)), ("b1", b1, (n, e)),
                           ("p0", p0, (n, b)), ("e_mask", e_mask, (n, e))):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_embrace: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != dev:
            raise ValueError(f"fused_embrace: {name} is on {t.device}, "
                             f"x0 on {dev}")
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_embrace: operands must be float32 or "
                        f"bfloat16, got {x0.dtype}")
    for name, t in (("x1", x1), ("w0", w0), ("w1", w1)):
        if t.dtype != x0.dtype:
            raise TypeError(f"fused_embrace: {name} is {t.dtype}, x0 "
                            f"{x0.dtype}")
    for name, t in (("b0", b0), ("b1", b1), ("p0", p0), ("e_mask", e_mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_embrace: {name} must be float32")
        if not t.is_contiguous():
            raise ValueError(f"fused_embrace: {name} must be contiguous")
    for name, t in (("x0", x0), ("x1", x1), ("w0", w0), ("w1", w1)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"fused_embrace: {name} needs unit stride "
                             f"along its last axis")
    if not 0 <= row_base <= 2 ** 31 - 1 - b:
        raise ValueError(f"fused_embrace: row_base {row_base} with {b} rows "
                         f"leaves the draw's 31-bit row counter")
    if isinstance(seed, torch.Tensor):
        if seed.shape not in ((), (n,)) or seed.dtype != torch.int64 \
                or seed.device != dev:
            raise ValueError(f"fused_embrace: a tensor seed must be a 0-d or "
                             f"[{n}] int64 on {dev}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")


#: features of an output tile of the tiled kernel
TILE_N = 128
#: K depth of a staged tile: 128 bytes of an x row in either operand type
TILE_K = {torch.float32: 32, torch.bfloat16: 64}
#: the largest portable thread-block cluster
MAX_SPLIT = 8


class LaunchPlan(NamedTuple):
    """How the tiled kernel covers one call: output tiles of ``bm`` rows x
    ``bn`` features, each computed by a cluster of ``split`` CTAs that
    share its K tiles (the kernel cuts them into ``split`` shares).  The
    kernel receives ``bm`` and ``split``; the rest is for the reader."""
    bm: int
    bn: int
    split: int
    row_tiles: int
    col_tiles: int

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.col_tiles * self.split


def launch_plan(B, E, D0, D1, dtype, sm_count, clusters=None) -> LaunchPlan:
    """The tiled kernel's plan for one trial's call on a card with
    ``sm_count`` SMs; a launch of T trials runs T times its tiles (the grid
    then takes several waves).  The plan, and so the order in which a
    tile's K is summed, does not depend on T: a trial's ``out`` is bit for
    bit the same in a population of any size.

    Tiles have 128 rows where 128-row tiles alone fill the SMs (the serving
    batch of 4096), else 64.  ``split`` is the largest, at most
    :data:`MAX_SPLIT` and at most x1's K tiles, that keeps one CTA an SM
    (tiles x split <= sm_count) and the grid in one wave: a cluster's CTAs
    share one GPC, so ``clusters(bm, split)`` says how many clusters of that
    size the card holds at once (:func:`clusters_at_once` on the card;
    ``sm_count // split`` where it is not given).  With that default, B =
    100 and B = 200 at E = 1024 split 8 and 4 ways: 128 CTAs (1,024 for a
    population of 8)."""
    fits = clusters or (lambda bm, split: sm_count // split)
    col_tiles = -(-E // TILE_N)
    bm = _tile_rows(B, col_tiles, sm_count)
    row_tiles = -(-B // bm)
    tiles = row_tiles * col_tiles
    k1_tiles = -(-D1 // TILE_K[dtype])
    split = next((s for s in range(min(MAX_SPLIT, k1_tiles), 1, -1)
                  if tiles * s <= sm_count and tiles <= fits(bm, s)), 1)
    return LaunchPlan(bm, TILE_N, split, row_tiles, col_tiles)


def _tile_rows(B, col_tiles, sm_count) -> int:
    """Output tile rows of both kernels: 128 where one trial's 128-row
    tiles alone fill the SMs (the serving batch of 4096), else 64 (the
    float32 64-row tile sums K in two groups, so a trial's rows depend on
    its own shape only)."""
    return 128 if -(-B // 128) * col_tiles >= sm_count else 64


class FullEPlan(NamedTuple):
    """How the full-E kernel covers one call: output tiles of ``bm`` rows x
    ``bn`` features, clusters of ``cluster`` CTAs spanning that many
    neighbouring column tiles of one row tile (each stage's x tile is
    multicast to all of them).  The kernel receives ``bm`` and
    ``cluster``; the rest is for the reader."""
    bm: int
    bn: int
    cluster: int
    row_tiles: int
    col_tiles: int

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def clusters(self) -> int:
        return self.ctas // self.cluster


def fulle_plan(B, E, D0, D1, dtype, sm_count, clusters=None,
               T=1) -> FullEPlan:
    """The full-E kernel's plan for a call of ``T`` trials on a card with
    ``sm_count`` SMs (``row_tiles`` counts every trial's; the tile rows are
    one trial's, so its sums do not depend on T, nor on the cluster, which
    splits no K).

    Tile rows as the tiled kernel's (:func:`launch_plan`), so both kernels
    run the same tiles and K order wherever that one splits no K.  The
    cluster width c divides the column tiles and is at most
    :data:`MAX_SPLIT`; the plan takes the c whose clusters run in the fewest
    waves, ``clusters(bm, c)`` being how many the card holds at once
    (:func:`clusters_at_once` with ``fulle=True`` on the card; ``sm_count //
    c`` where it is not given), then the widest, which reads x the fewest
    times.  No K is split: the kernel walks all of D0 and D1 in every CTA,
    whatever their widths."""
    del D0, D1, dtype   # the plan does not depend on them
    fits = clusters or (lambda bm, c: sm_count // c)
    col_tiles = -(-E // TILE_N)
    bm = _tile_rows(B, col_tiles, sm_count)
    row_tiles = T * -(-B // bm)

    def waves(c):
        at_once = fits(bm, c)
        n = row_tiles * col_tiles // c
        return -(-n // at_once) if at_once > 0 else float("inf")

    widths = [c for c in range(min(MAX_SPLIT, col_tiles), 0, -1) if col_tiles % c == 0]
    c = min(widths, key=lambda c: (waves(c), -c))
    if waves(c) == float("inf"):
        raise RuntimeError(f"fulle_plan: no cluster of {bm}-row tiles fits "
                           f"on the card")
    return FullEPlan(bm, TILE_N, c, row_tiles, col_tiles)


@lru_cache(maxsize=None)
def clusters_at_once(dtype, bm, split, index=None, fulle=False) -> int:
    """How many clusters of ``split`` CTAs of ``bm``-row tiles of the tiled
    kernel (of the full-E kernel where ``fulle``) the card (CUDA device
    ``index``, the current one by default) holds at once: CUDA's occupancy
    query, which knows how the SMs fall into GPCs.  Raises
    ``RuntimeError`` where the query fails."""
    # a grid of one cluster: one tile split `split` ways, or `split` tiles
    E = split * TILE_N if fulle else TILE_N
    with torch.cuda.device(index):
        n = _load().embrace_fused_fwd_clusters(int(fulle), _DTYPE_CODE[dtype],
                                               bm, E, bm, split)
    if n < 0:
        kernel = "full-E" if fulle else "tiled"
        raise RuntimeError(f"embrace_fused_fwd_clusters: the occupancy query "
                           f"failed for the {kernel} kernel's {dtype} "
                           f"{bm}-row tiles in clusters of {split} on CUDA "
                           f"device {index}")
    return n


@lru_cache(maxsize=None)
def card_plan(B, E, D0, D1, dtype, index) -> LaunchPlan:
    """:func:`launch_plan` for CUDA device ``index``, from its SM count and
    its occupancy query; the wrapper's plan."""
    return launch_plan(
        B, E, D0, D1, dtype,
        torch.cuda.get_device_properties(index).multi_processor_count,
        lambda bm, split: clusters_at_once(dtype, bm, split, index))


@lru_cache(maxsize=None)
def card_fulle_plan(B, E, D0, D1, dtype, index, T=1) -> FullEPlan:
    """:func:`fulle_plan` for CUDA device ``index``, from its SM count and
    its occupancy query for the full-E kernel; the wrapper's plan."""
    return fulle_plan(
        B, E, D0, D1, dtype,
        torch.cuda.get_device_properties(index).multi_processor_count,
        lambda bm, c: clusters_at_once(dtype, bm, c, index, fulle=True), T)


def tma_problem(shape, strides, itemsize, address):
    """Why TMA cannot read an operand with this ``shape`` (``[rows, cols]``
    or ``[T, rows, cols]``), ``strides`` (elements), element size and base
    address; ``None`` where it can.  TMA needs unit stride along the last
    axis, a 16-byte aligned base, for more than one row a row stride that
    covers the row and is a multiple of 16 bytes, and for more than one
    trial a trial stride that is a multiple of 16 bytes."""
    rows, cols = shape[-2:]
    if cols > 1 and strides[-1] != 1:
        return "needs unit stride along its last axis"
    if address % 16:
        return f"base address {address:#x} is not 16-byte aligned"
    if rows > 1 and (strides[-2] * itemsize % 16 or strides[-2] < cols):
        return (f"row stride of {strides[-2] * itemsize} bytes is not a "
                f"multiple of 16 bytes covering its {cols} columns")
    if len(shape) == 3 and shape[0] > 1 and strides[0] * itemsize % 16:
        return (f"trial stride of {strides[0] * itemsize} bytes is not a "
                f"multiple of 16 bytes")
    return None


def tma_x0(x0):
    """``x0`` (``[B, D0]`` or ``[T, B, D0]``) as TMA can read it: itself,
    or where its row or trial stride is not a multiple of 16 bytes (D0 = 4
    with bf16 operands) a copy zero-padded to the next multiple.  The kernel reads D0
    columns of it and w0's D0 rows, so the padding never enters a sum."""
    per = 16 // x0.element_size()
    x = x0 if x0.dim() == 3 else x0[None]
    n, b = x.shape[:2]
    if (b <= 1 or x.stride(1) % per == 0) and (n <= 1 or x.stride(0) % per == 0):
        return x0
    padded = x.new_zeros(n, b, -(-x.shape[2] // per) * per)
    padded[..., :x.shape[2]] = x
    return padded if x0.dim() == 3 else padded[0]


def _check_tma(x0, x1, w0, w1):
    for name, t in (("x0", x0), ("x1", x1), ("w0", w0), ("w1", w1)):
        why = tma_problem(tuple(t.shape), t.stride(), t.element_size(),
                          t.data_ptr())
        if why:
            raise ValueError(f"fused_embrace: TMA cannot read {name}: {why}")


def _launch_args(entry: str, x0, x1, w0, w1):
    """``(x0, plan)`` for a launch of kernel ``entry`` on operands with
    (``[T, ...]``) or without a trial axis: x0 as TMA reads it
    (:func:`tma_x0`) and the plan arguments, ``(bm, split)`` of
    :func:`card_plan` or ``(bm, cluster)`` of :func:`card_fulle_plan`.
    Raises ``ValueError`` for an operand TMA cannot read, before anything
    asks the card."""
    x0 = tma_x0(x0)
    _check_tma(x0, x1, w0, w1)
    n = x0.shape[0] if x0.dim() == 3 else 1
    shape = (x0.shape[-2], w0.shape[-1], w0.shape[-2], x1.shape[-1], x0.dtype,
             x0.device.index)
    if entry == "embrace_fused_fwd":
        p = card_plan(*shape)
        return x0, (p.bm, p.split)
    p = card_fulle_plan(*shape, *((n,) if n > 1 else ()))
    return x0, (p.bm, p.cluster)


def _forward(entry: str, x0, x1, w0, b0, w1, b1, p0, e_mask, seed,
             row_base=0):
    """``(out, choose)`` from the kernel ``entry`` on CUDA tensors, or from
    the plain version on CPU tensors; a call without a trial axis is one
    trial.  On the CPU trial t's uniforms are rows ``[row_base, row_base +
    B)`` of what ``torch.Generator().manual_seed(seed_t)`` draws for a batch
    of ``row_base + B`` rows (the CPU generator fills rows in order, so
    they are the whole batch's rows) at the trial's live width, up to the
    last column its ``e_mask`` keeps (zeros past it, where ``out`` is 0):
    a trial draws the same in any width bucket, as the kernel's Philox
    draw, keyed by (row, column), does by construction."""
    if x0.dim() == 2:
        if isinstance(seed, torch.Tensor) and seed.dim() != 0:
            raise ValueError(f"fused_embrace: without a trial axis a tensor "
                             f"seed must be a 0-d int64, got "
                             f"{tuple(seed.shape)}")
        out, choose = _forward(entry, x0[None], x1[None], w0[None], b0[None],
                               w1[None], b1[None], p0[None], e_mask[None],
                               seed, row_base)
        return out[0], choose[0]
    row_base = int(row_base)
    _check(x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base)
    n, b, e = x0.shape[0], x0.shape[1], w0.shape[2]
    if x0.device.type == "cpu":
        seeds = (seed.reshape(-1).expand(n).tolist()
                 if isinstance(seed, torch.Tensor) else [seed] * n)
        cols = torch.arange(1, e + 1)
        live = ((e_mask != 0) * cols).amax(-1).tolist()   # last kept column + 1
        u = torch.zeros((n, b, e))
        for t, (s, w) in enumerate(zip(seeds, live)):
            u[t, :, :w] = torch.rand((row_base + b, w), generator=torch
                                     .Generator().manual_seed(int(s)))[row_base:]
        return fused_embrace_reference(x0, x1, w0, b0, w1, b1, p0, e_mask, u)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_embrace: unsupported device {x0.device}")
    lib = _load()
    x0, plan = _launch_args(entry, x0, x1, w0, w1)
    out = torch.empty((n, b, e), dtype=torch.float32, device=x0.device)
    choose = torch.empty((n, b, e), dtype=torch.uint8, device=x0.device)
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1).expand(n).contiguous()
        seed_val, seed_ptr = 0, seed.data_ptr()
    else:
        seed_val, seed_ptr = int(seed) & 0xFFFFFFFF, None
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = getattr(lib, entry)(
            _DTYPE_CODE[x0.dtype],
            *(v for t in (x0, x1, w0, w1)
              for v in (t.data_ptr(), t.stride(1), t.stride(0))),
            b0.data_ptr(), b1.data_ptr(), p0.data_ptr(), e_mask.data_ptr(),
            out.data_ptr(), choose.data_ptr(),
            n, b, w0.shape[1], x1.shape[2], e, seed_val, seed_ptr, row_base,
            stream, *plan)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name(x0.device)})")
    return out, choose


def embrace_backward(g, x0, x1, w0, w1, e_mask, choose, out):
    """The JAX ``_bwd`` (``ops/pallas/embrace.py:251-271``) term for term,
    in float32 from the saved operands: ``(dx0, dx1, dw0, db0, dw1, db1)``,
    per trial where the operands have a trial axis.
    ``out > 0`` is ReLU's derivative on the selected branch."""
    from embracenet_tpu_torch.models.layers import (_highest_matmul_precision,
                                                    trial_matmul as mm)

    g = g.float() * e_mask.unsqueeze(-2)
    live = (out > 0).float()
    c = choose.float()
    g0 = g * c * live
    g1 = g * (1.0 - c) * live
    # with a trial axis, batched products (JAX computes the vmapped _bwd
    # outside Pallas too)
    with _highest_matmul_precision():
        dx0 = mm(g0, w0.float().transpose(-1, -2))
        dw0 = mm(x0.float().transpose(-1, -2), g0)
        dx1 = mm(g1, w1.float().transpose(-1, -2))
        dw1 = mm(x1.float().transpose(-1, -2), g1)
    return dx0, dx1, dw0, g0.sum(-2), dw1, g1.sum(-2)


class FusedEmbrace(torch.autograd.Function):
    """Fused docking + embracement with the JAX custom VJP's gradient.  On
    both devices the backward is :func:`embrace_backward`; no gradient
    flows to ``p0``, ``e_mask`` or ``seed`` (the draw is not
    differentiated).  Each returned gradient has its input's dtype."""

    @staticmethod
    def forward(ctx, x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base=0):
        out, choose = _forward("embrace_fused_fwd", x0, x1, w0, b0, w1, b1,
                               p0, e_mask, seed, row_base)
        if out.is_cuda:
            count("embrace.launches")
        ctx.save_for_backward(x0, x1, w0, w1, e_mask, choose, out)
        ctx.mark_non_differentiable(choose)
        return out, choose

    @staticmethod
    def backward(ctx, g, _g_choose):
        x0, x1, w0, w1, e_mask, choose, out = ctx.saved_tensors
        dx0, dx1, dw0, db0, dw1, db1 = embrace_backward(g, x0, x1, w0, w1,
                                                        e_mask, choose, out)
        return (dx0.to(x0.dtype), dx1.to(x1.dtype), dw0.to(w0.dtype), db0,
                dw1.to(w1.dtype), db1, None, None, None, None)


def fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base=0):
    """Fused docking + stochastic embracement -> ``(out [B, E] float32,
    choose [B, E] uint8)``, differentiable in x0, x1, w0, b0, w1, b1.

    x0 [B, D0], x1 [B, D1]; w0 [D0, E], w1 [D1, E] (float32 or bfloat16,
    all four alike; the weights may be row-strided views, and their
    gradients land in the viewed slice of the base tensor); b0, b1, e_mask
    [E] and p0 [B] float32 (p0 = probability of modality 0 per row); seed
    an int or a 0-d int64 tensor on the operands' device; ``row_base`` the
    batch row of x0's first row (a shard of a batch draws that batch's
    uniforms for its rows).  A population of T trials in one launch: every
    operand with a leading ``[T]`` axis and ``seed`` a ``[T]`` int64 tensor
    (or one key for all).  CUDA tensors go to the kernel; CPU tensors to
    the plain version with uniforms from
    ``torch.Generator().manual_seed(seed)`` at the live width of ``e_mask``
    (:func:`_forward`).
    """
    return FusedEmbrace.apply(x0, x1, w0, b0, w1, b1, p0, e_mask, seed,
                              row_base)


def fused_embrace_fulle(x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base=0):
    """The full-E kernel: :func:`fused_embrace`'s forward with a cluster of
    CTAs spanning E that share each x tile (:func:`fulle_plan`).  Forward
    only, as the JAX ``_fused_fwd_fulle``: it raises where autograd would
    need a gradient of it, instead of returning an output that trains
    nothing."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, x1, w0, b0, w1, b1)):
        raise RuntimeError("fused_embrace_fulle is forward only; use "
                           "fused_embrace for a differentiable call")
    out, choose = _forward("embrace_fused_fwd_fulle", x0, x1, w0, b0, w1, b1,
                           p0, e_mask, seed, row_base)
    if out.is_cuda:
        count("embrace.launches_fulle")
    return out, choose
