"""Native runtime: ctypes bindings to the C++ IO/codec accelerator (port of
``embracenet_tpu/runtime``).

``ioaccel.cpp`` is host code: the FASTA parse, the sequence encoder and a
brute-force kNN.  It is built at first use with the system ``g++`` into the
gitignored ``embracenet_tpu_torch/_build/`` (once per source content and
flags); the JAX package builds its copy beside its own source instead.
The contract is the JAX package's: the native path when the library builds,
the numpy path otherwise; :func:`available` says which one runs.  Each entry
point returns None when the library is not available, and the caller takes
its numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "ioaccel.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None
#: why the library is not available (the compiler's message), or None
BUILD_ERROR: str | None = None


def _build() -> Path:
    """Compile ``ioaccel.cpp`` (once per source content and flags) and
    return the shared library's path; raises OSError or RuntimeError when
    there is no compiler or it fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libioaccel_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    global _lib, BUILD_ERROR
    if _lib is not None or BUILD_ERROR is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as exc:
        BUILD_ERROR = str(exc)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    lib.enc_encode_sequences.argtypes = [u8p, i64, u8p, u64]
    lib.enc_encode_sequences.restype = None
    lib.enc_parse_fasta.argtypes = [u8p, i64, i64, u8p, i64,
                                    ctypes.POINTER(i64), u64]
    lib.enc_parse_fasta.restype = i64
    lib.enc_knn.argtypes = [ctypes.POINTER(ctypes.c_double), i64,
                            ctypes.POINTER(ctypes.c_double), i64, i64,
                            i64, i64, ctypes.POINTER(ctypes.c_int32)]
    lib.enc_knn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded (the native path
    runs), False when the numpy path runs."""
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_sequences_native(seqs: list[str], seed: int = 0) -> np.ndarray | None:
    """Native equivalent of ``data.codec.encode_sequences``: unknown bases
    from the xorshift stream seeded with ``seed`` (0 counts as 1, as in the
    JAX package); None if the library is not available."""
    lib = _load()
    if lib is None or not seqs:
        return None
    length = len(seqs[0])
    buf = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    if buf.size != length * len(seqs):
        raise ValueError("sequences must all have the same length")
    out = np.empty(buf.shape, np.uint8)
    lib.enc_encode_sequences(_u8(buf), buf.size, _u8(out),
                             ctypes.c_uint64(seed or 1))
    return out.reshape(len(seqs), length)


def parse_fasta_native(path: str, seq_len: int = 256, seed: int = 0):
    """-> (codes [N, seq_len] uint8, headers list[str]) of a sequence-first
    ``.fa`` file, or None if the library is not available."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        raw = fh.read()
    buf = np.frombuffer(raw, dtype=np.uint8)
    max_rows = max(len(raw) // (seq_len + 2), 1)
    out = np.empty((max_rows, seq_len), np.uint8)
    offsets = np.empty(max_rows, np.int64)
    n = lib.enc_parse_fasta(_u8(buf), buf.size, seq_len, _u8(out), max_rows,
                            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                            ctypes.c_uint64(seed or 1))
    if n < 0:
        raise ValueError(f"{path}: sequence length != {seq_len}")
    headers = []
    for off in offsets[:n]:
        end = raw.find(b"\n", off)
        headers.append(raw[off:len(raw) if end < 0 else end].decode().strip())
    return out[:n].copy(), headers


def knn_native(ref: np.ndarray, query: np.ndarray, k: int,
               self_exclude: bool) -> np.ndarray | None:
    """[len(query), k] indices of each query row's k nearest ``ref`` rows
    by squared distance summed feature by feature in float64, nearest
    first, ties by row index (``self_exclude``: query row q skips ref row
    q); None if the library is not available or k > 64."""
    lib = _load()
    if lib is None or k > 64:
        return None
    ref = np.ascontiguousarray(ref, np.float64)
    query = np.ascontiguousarray(query, np.float64)
    if ref.ndim != 2 or query.ndim != 2 or ref.shape[1] != query.shape[1]:
        raise ValueError(f"ref {ref.shape} and query {query.shape} must be "
                         "matrices of one width")
    out = np.empty((len(query), k), np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.enc_knn(ref.ctypes.data_as(dp), len(ref), query.ctypes.data_as(dp),
                len(query), ref.shape[1], k, int(self_exclude),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
