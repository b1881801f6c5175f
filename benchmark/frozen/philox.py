"""The embracement's draw, as ``csrc/embrace.cu`` documents it: for trial
key ``seed``, batch row ``r`` and feature ``c``, the top 24 bits of word 0
of Philox4x32-10 with key ``(seed, 0)`` and counter ``(r, c, 0, 0)``,
times 2**-24; the kernel keeps modality 0 where that is below ``p0`` of the
row.  Written again in numpy, with 64-bit products for the 32-bit
multiply-high, so the reference works the draws out itself."""

from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)


def philox_uniform(seed: int, rows: int, cols: int, row_base: int = 0):
    """float32 ``[rows, cols]`` uniforms on [0, 1) for rows ``row_base ..
    row_base + rows - 1``."""
    r = np.arange(row_base, row_base + rows, dtype=np.uint64)[:, None]
    c = np.arange(cols, dtype=np.uint64)[None, :]
    c0 = np.broadcast_to(r, (rows, cols)).copy()
    c1 = np.broadcast_to(c, (rows, cols)).copy()
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    k0, k1 = np.uint64(int(seed) & 0xFFFFFFFF), np.uint64(0)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & _M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & _M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + np.uint64(0x9E3779B9)) & _M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & _M32
    return ((c0 >> np.uint64(8)).astype(np.float32)
            * np.float32(1.0 / 16777216.0))
