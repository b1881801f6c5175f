"""Fused EmbraceNet docking + stochastic embracement (forward).

Port of the Pallas TPU kernel ``embracenet_tpu/ops/pallas/embrace.py``
(``_kernel`` behind ``fused_embrace``).  Both docking matmuls, the ReLU,
the per-(row, feature) Bernoulli draw and the select run in one CUDA kernel
written for Hopper (``csrc/embrace.cu``), so the ``[B, E]`` docking
activations never reach device memory.

* :func:`fused_embrace` is the wrapper.  On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs :func:`fused_embrace_reference`
  with uniforms from a ``torch.Generator`` seeded with ``seed``.
* :func:`fused_embrace_reference` is the plain PyTorch version of the same
  function with the uniforms ``u`` given: the tests and ``chip_smoke.py``
  hold the kernel against it.
* ``LAUNCHES`` counts kernel launches, so a run can show that its path went
  through the kernel.

Stated divergences from the TPU kernel: the draw is Philox4x32-10 keyed by
``seed`` with counter (row, feature), not the TPU's PRNG (same distribution,
different stream); and the operands keep the dtype the caller gives
(float32 or bfloat16, following ``compute_dtype``) where the TPU wrapper
always cast them to bfloat16.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
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
        fn = lib.embrace_fused_fwd
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [i32, p, i64, p, i64, p, i64, p, i64,
                       p, p, p, p, p, p, i32, i32, i32, i32, ctypes.c_uint, p]
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


def _check(x0, x1, w0, b0, w1, b1, p0, e_mask):
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


def fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, seed: int):
    """Fused docking + stochastic embracement -> ``(out [B, E] float32,
    choose [B, E] uint8)``.

    x0 [B, D0], x1 [B, D1]; w0 [D0, E], w1 [D1, E] (float32 or bfloat16,
    all four alike; the weights may be row-strided views); b0, b1, e_mask
    [E] and p0 [B] float32 (p0 = probability of modality 0 per row); seed
    an int.  CUDA tensors go to the kernel; CPU tensors to the plain
    version with uniforms from ``torch.Generator().manual_seed(seed)``.
    """
    global LAUNCHES
    _check(x0, x1, w0, b0, w1, b1, p0, e_mask)
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
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = lib.embrace_fused_fwd(
            _DTYPE_CODE[x0.dtype],
            x0.data_ptr(), x0.stride(0), x1.data_ptr(), x1.stride(0),
            w0.data_ptr(), w0.stride(0), w1.data_ptr(), w1.stride(0),
            b0.data_ptr(), b1.data_ptr(), p0.data_ptr(), e_mask.data_ptr(),
            out.data_ptr(), choose.data_ptr(),
            b, x0.shape[1], x1.shape[1], e, int(seed) & 0xFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"fused_embrace: CUDA launch failed with error "
                           f"{err} ({torch.cuda.get_device_name(x0.device)})")
    LAUNCHES += 1
    return out, choose
