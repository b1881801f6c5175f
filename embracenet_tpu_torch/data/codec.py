"""DNA sequence codec (port of ``embracenet_tpu/data/codec.py``).

Sequences are encoded once to ``uint8`` codes ``[N, 256]`` (``a=0, c=1, g=2,
t=3``, alphabetical channel order as in the reference's ``OneHotEncoder``,
`data_pipe/utils.py:270`); the one-hot ``[B, 4, 256]`` is built on the
device by :func:`one_hot`.  ``n`` (unknown base) becomes a uniformly random
base at encode time (`data_pipe/utils.py:272-274`).

The native C++ encoder (``runtime/ioaccel.cpp``) runs when it builds and
the numpy path otherwise, as in the JAX package; the two fill ``n`` bases
from different streams (xorshift seeded with the integer seed, numpy's
generator), and each equals the JAX package's path of the same kind, so
both packages encode a sequence with ``n`` bases to the same codes
whenever they take the same path.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_ORDER = "acgt"

# Byte lookup table: ASCII -> code; 255 marks "n"/unknown (resolved randomly).
_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASE_ORDER):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.upper())] = _i


def encode_sequences(seqs, rng: np.random.Generator | int = 0,
                     native: bool = True) -> np.ndarray:
    """Encode an iterable of equal-length DNA strings to uint8 codes [N, L].

    ``native`` takes the C++ encoder when the runtime is available (an int
    ``rng`` seeds its stream; a generator counts as seed 0, as in the JAX
    package); otherwise, or with ``native=False``, numpy's generator fills
    the unknown bases."""
    seqs = list(seqs)
    if not seqs:
        return np.zeros((0, 0), dtype=np.uint8)
    if native:
        from embracenet_tpu_torch import runtime

        seed = rng if isinstance(rng, (int, np.integer)) else 0
        out = runtime.encode_sequences_native(seqs, seed=int(seed))
        if out is not None:
            return out
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(int(rng))
    length = len(seqs[0])
    buf = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    codes = _LUT[buf].reshape(len(seqs), length)
    unknown = codes == 255
    if unknown.any():
        codes[unknown] = rng.integers(0, 4, size=int(unknown.sum()), dtype=np.uint8)
    return codes


def decode_sequences(codes: np.ndarray) -> list[str]:
    """Inverse of :func:`encode_sequences` (codes must be in [0, 4))."""
    table = np.frombuffer(BASE_ORDER.encode(), dtype=np.uint8)
    return [table[row].tobytes().decode("ascii") for row in np.asarray(codes)]


def complement_codes(codes) -> np.ndarray:
    """Complement strand on codes: a<->t, c<->g, i.e. ``3 - code`` (the
    reference's ``reverse_strand`` only complements, `data_pipe/utils.py:327-339`)."""
    codes = np.asarray(codes)
    return (3 - codes.astype(np.int16)).astype(codes.dtype)


_COMPLEMENT_TABLE = str.maketrans("acgtn", "tgcan")


def complement_strand(sequence: str) -> str:
    """String-level complement, lower case, ``n -> n``, order kept (the
    reference's ``reverse_strand``)."""
    return sequence.lower().translate(_COMPLEMENT_TABLE)


def one_hot(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Device-side one-hot: uint8 codes [..., L] -> [..., 4, L].

    A code outside [0, 4) gives an all-zero column, as ``jax.nn.one_hot``
    does (``torch.nn.functional.one_hot`` would raise instead).
    """
    bases = torch.arange(4, device=codes.device).view(4, 1)
    return (codes.unsqueeze(-2).long() == bases).to(dtype)
