"""Fused EmbraceNet docking + stochastic embracement.

Port of the Pallas TPU kernels of ``embracenet_tpu/ops/pallas/embrace.py``
(``_kernel`` behind ``fused_embrace``, and its full-E variant
``_kernel_fulle`` behind ``_fused_fwd_fulle``).  Both docking matmuls, the
ReLU, the per-(row, feature) Bernoulli draw and the select run in one CUDA
kernel written for Hopper (``csrc/embrace.cu``), so the ``[B, E]`` docking
activations never reach device memory.

* :func:`fused_embrace` is differentiable (:class:`FusedEmbrace`, the
  counterpart of the JAX custom VJP).  Its forward is the tiled kernel on a
  CUDA tensor and :func:`fused_embrace_reference` with uniforms from a
  ``torch.Generator`` seeded with ``seed`` on a CPU tensor; its backward is
  the JAX ``_bwd``: three masked products in float32, which JAX left to XLA
  and which stay ``torch.matmul`` (cuBLAS on the card) here.
* :func:`fused_embrace_fulle` is the full-E kernel, forward only as in JAX.
  It computes the same function and draws the same Philox stream, so for
  the same seed both kernels choose identically (the TPU reseeded per
  B-block, ``seed + i``, so its two kernels did not).
* :func:`fused_embrace_reference` is the plain PyTorch version with the
  uniforms ``u`` given: the tests and ``chip_smoke.py`` hold both kernels
  against it.
* ``LAUNCHES`` and ``LAUNCHES_FULLE`` count kernel launches, so a run can
  show that its path went through the kernel.

Stated divergences from the TPU kernels: the draw is Philox4x32-10 keyed by
``seed`` with counter (row, feature), not the TPU's PRNG (same
distribution, different stream); and the operands keep the dtype the caller
gives (float32 or bfloat16, following ``compute_dtype``) where the TPU
wrapper always cast them to bfloat16.

``seed`` is an int or a 0-d int64 tensor on the operands' device; the
kernels read a tensor seed from device memory, so a seed drawn on the card
never waits for the host.

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
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "embrace.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches made by :func:`fused_embrace` (one per CUDA call)
LAUNCHES = 0
#: kernel launches made by :func:`fused_embrace_fulle`
LAUNCHES_FULLE = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: what the last build printed (ptxas registers / spills) and its seconds
BUILD_LOG = ""
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused embrace kernel is built "
                           "from csrc/embrace.cu with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile ``csrc/embrace.cu`` (once per source content) and return the
    shared library's path."""
    global BUILD_LOG, BUILD_SECONDS
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libembrace_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.embrace_fused_fwd, lib.embrace_fused_fwd_fulle):
            fn.argtypes = [i32, p, i64, p, i64, p, i64, p, i64, p, p, p, p,
                           p, p, i32, i32, i32, i32, ctypes.c_uint, p, p]
            fn.restype = i32
        _lib = lib
    return _lib


def fused_embrace_reference(x0, x1, w0, b0, w1, b1, p0, e_mask, u):
    """Plain PyTorch version: ``(out, choose)`` with ``out = where(u <
    p0[:, None], relu(x0 @ w0 + b0), relu(x1 @ w1 + b1)) * e_mask`` and
    ``choose`` as uint8.  Operands are upcast to float32 (bf16 operands
    are exact there), products taken at full float32 precision."""
    from embracenet_tpu_torch.models.layers import linear

    d0 = torch.relu(linear(x0.float(), w0.float(), b0))
    d1 = torch.relu(linear(x1.float(), w1.float(), b1))
    pick0 = u < p0[:, None]
    return torch.where(pick0, d0, d1) * e_mask, pick0.to(torch.uint8)


def _check(x0, x1, w0, b0, w1, b1, p0, e_mask, seed):
    dev = x0.device
    b, d0 = x0.shape
    d1, e = x1.shape[1], w0.shape[1]
    for name, t, shape in (("x0", x0, (b, d0)), ("x1", x1, (b, d1)),
                           ("w0", w0, (d0, e)), ("w1", w1, (d1, e)),
                           ("b0", b0, (e,)), ("b1", b1, (e,)),
                           ("p0", p0, (b,)), ("e_mask", e_mask, (e,))):
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
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"fused_embrace: {name} needs unit stride "
                             f"along its last axis")
    if isinstance(seed, torch.Tensor):
        if seed.shape != () or seed.dtype != torch.int64 or seed.device != dev:
            raise ValueError(f"fused_embrace: a tensor seed must be a 0-d "
                             f"int64 on {dev}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")


def _forward(entry: str, x0, x1, w0, b0, w1, b1, p0, e_mask, seed):
    """``(out, choose)`` from the kernel ``entry`` on a CUDA tensor, or from
    the plain version with ``torch.Generator().manual_seed(seed)``
    uniforms on a CPU tensor."""
    _check(x0, x1, w0, b0, w1, b1, p0, e_mask, seed)
    b, e = x0.shape[0], w0.shape[1]
    if x0.device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed))
        u = torch.rand((b, e), generator=gen)
        return fused_embrace_reference(x0, x1, w0, b0, w1, b1, p0, e_mask, u)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_embrace: unsupported device {x0.device}")
    lib = _load()
    out = torch.empty((b, e), dtype=torch.float32, device=x0.device)
    choose = torch.empty((b, e), dtype=torch.uint8, device=x0.device)
    if isinstance(seed, torch.Tensor):
        seed_val, seed_ptr = 0, seed.data_ptr()
    else:
        seed_val, seed_ptr = int(seed) & 0xFFFFFFFF, None
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = getattr(lib, entry)(
            _DTYPE_CODE[x0.dtype],
            x0.data_ptr(), x0.stride(0), x1.data_ptr(), x1.stride(0),
            w0.data_ptr(), w0.stride(0), w1.data_ptr(), w1.stride(0),
            b0.data_ptr(), b1.data_ptr(), p0.data_ptr(), e_mask.data_ptr(),
            out.data_ptr(), choose.data_ptr(),
            b, x0.shape[1], x1.shape[1], e, seed_val, seed_ptr, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name(x0.device)})")
    return out, choose


def embrace_backward(g, x0, x1, w0, w1, e_mask, choose, out):
    """The JAX ``_bwd`` (``ops/pallas/embrace.py:251-271``) term for term,
    in float32 from the saved operands: ``(dx0, dx1, dw0, db0, dw1, db1)``.
    ``out > 0`` is ReLU's derivative on the selected branch."""
    from embracenet_tpu_torch.models.layers import _highest_matmul_precision

    g = g.float() * e_mask[None, :]
    live = (out > 0).float()
    c = choose.float()
    g0 = g * c * live
    g1 = g * (1.0 - c) * live
    with _highest_matmul_precision():
        dx0 = g0 @ w0.float().T
        dw0 = x0.float().T @ g0
        dx1 = g1 @ w1.float().T
        dw1 = x1.float().T @ g1
    return dx0, dx1, dw0, g0.sum(0), dw1, g1.sum(0)


class FusedEmbrace(torch.autograd.Function):
    """Fused docking + embracement with the JAX custom VJP's gradient.  On
    both devices the backward is :func:`embrace_backward`; no gradient
    flows to ``p0``, ``e_mask`` or ``seed`` (the draw is not
    differentiated).  Each returned gradient has its input's dtype."""

    @staticmethod
    def forward(ctx, x0, x1, w0, b0, w1, b1, p0, e_mask, seed):
        global LAUNCHES
        out, choose = _forward("embrace_fused_fwd", x0, x1, w0, b0, w1, b1,
                               p0, e_mask, seed)
        if out.is_cuda:
            LAUNCHES += 1
        ctx.save_for_backward(x0, x1, w0, w1, e_mask, choose, out)
        ctx.mark_non_differentiable(choose)
        return out, choose

    @staticmethod
    def backward(ctx, g, _g_choose):
        x0, x1, w0, w1, e_mask, choose, out = ctx.saved_tensors
        dx0, dx1, dw0, db0, dw1, db1 = embrace_backward(g, x0, x1, w0, w1,
                                                        e_mask, choose, out)
        return (dx0.to(x0.dtype), dx1.to(x1.dtype), dw0.to(w0.dtype), db0,
                dw1.to(w1.dtype), db1, None, None, None)


def fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, seed):
    """Fused docking + stochastic embracement -> ``(out [B, E] float32,
    choose [B, E] uint8)``, differentiable in x0, x1, w0, b0, w1, b1.

    x0 [B, D0], x1 [B, D1]; w0 [D0, E], w1 [D1, E] (float32 or bfloat16,
    all four alike; the weights may be row-strided views, and their
    gradients land in the viewed slice of the base tensor); b0, b1, e_mask
    [E] and p0 [B] float32 (p0 = probability of modality 0 per row); seed
    an int or a 0-d int64 tensor on the operands' device.  CUDA tensors go
    to the kernel; CPU tensors to the plain version with uniforms from
    ``torch.Generator().manual_seed(seed)``.
    """
    return FusedEmbrace.apply(x0, x1, w0, b0, w1, b1, p0, e_mask, seed)


def fused_embrace_fulle(x0, x1, w0, b0, w1, b1, p0, e_mask, seed):
    """The full-E kernel: :func:`fused_embrace`'s forward with one block per
    8 rows and the whole E width, so ``x1`` is read once.  Forward only, as
    the JAX ``_fused_fwd_fulle``: it raises where autograd would need a
    gradient of it, instead of returning an output that trains nothing."""
    global LAUNCHES_FULLE
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, x1, w0, b0, w1, b1)):
        raise RuntimeError("fused_embrace_fulle is forward only; use "
                           "fused_embrace for a differentiable call")
    out, choose = _forward("embrace_fused_fwd_fulle", x0, x1, w0, b0, w1, b1,
                           p0, e_mask, seed)
    if out.is_cuda:
        LAUNCHES_FULLE += 1
    return out, choose
