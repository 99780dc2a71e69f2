"""murmur3-style 32-bit mixers for packed k-mer keys, in PyTorch — the
counterpart of ``kaarme_tpu/ops/hashing.py``, bit for bit.

Key words arrive as int32 tensors holding uint32 bit patterns (or int64
values in [0, 2^32)); the hashes come back as int64 values in
[0, 2^32).  PyTorch has no uint32 multiply, and a product of two 32-bit
values can pass 2^63 in int64, so ``_mul32`` splits the constant into
16-bit halves: every partial product stays below 2^48 and the low 32
bits are exact by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .sortcount import M32

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_N = 0xE6546B64


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full avalanche on 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_words(words, seed: int = 0x9747B28C) -> torch.Tensor:
    """murmur3_x86_32 over a sequence of W word columns of one shape.
    ``hash_words.calls`` counts the calls (chip_smoke checks that the
    probe table's count step and the ``-b`` path make none: T1, B1 and
    B2 hash in the kernels)."""
    hash_words.calls += 1
    h = torch.full(words[0].shape, seed, dtype=torch.int64, device=words[0].device)
    for w in words:
        kx = _mul32(w.to(torch.int64) & M32, _C1)
        kx = _mul32(_rotl(kx, 15), _C2)
        h = _rotl(h ^ kx, 13)
        h = (_mul32(h, 5) + _N) & M32
    return fmix32(h ^ (4 * len(words)))


hash_words.calls = 0


def hash_words64(words, seed_lo: int = 0x9747B28C, seed_hi: int = 0x5BD1E995):
    """Two independent 32-bit hashes (the Bloom filter's root hash)."""
    return hash_words(words, seed_lo), hash_words(words, seed_hi)


def hash_words_np(words, seed: int = 0x9747B28C) -> np.ndarray:
    """NumPy mirror of ``hash_words`` as uint32 (host-side query routing
    must agree bit for bit with the device hash)."""

    def rotl(x, r):
        return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)

    with np.errstate(over="ignore"):
        h = np.full(np.asarray(words[0]).shape, seed, np.uint32)
        for w in words:
            kx = np.asarray(w, np.uint32) * np.uint32(_C1)
            kx = rotl(kx, 15) * np.uint32(_C2)
            h = rotl(h ^ kx, 13) * np.uint32(5) + np.uint32(_N)
        h = h ^ np.uint32(4 * len(words))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
