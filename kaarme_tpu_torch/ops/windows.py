"""Canonical k-mer windows of code tiles, in PyTorch — the counterpart of
``kaarme_tpu/ops/windows.py`` (XLA ops in the JAX package), value for
value.

Packing: base i of a window occupies word i//16 at bit 30 - 2*(i % 16)
(big-endian within and across words, trailing word left-aligned), so
lexicographic order over the base string equals numeric order over the
word tuple, and the canonical pick (min of forward and reverse
complement, ties to forward) is a word-wise compare and select.  A
window is valid iff all k codes are < 4.

Key words are int64 tensors holding values in [0, 2^32) (torch on the
CPU has no uint32 shifts or compares); ``sortcount.i32`` narrows them to
the int32 bit patterns the kernels take.  Invalid windows get keys too
(the JAX package's, bit for bit); ``valid`` masks them.

The counting routes do not call this module: the table route takes its
windows from the transfer chunk through K3
(``sortcount.window_keys_from_chunk``), which gives every valid window
the same key, and T1 hashes it as ``hash_words`` does.  It is the JAX
module's interface on code tiles, for library callers that hold codes.
"""

from __future__ import annotations

import torch

from .hashing import hash_words
from .sortcount import M32


def words_per_kmer(k: int) -> int:
    return (k + 15) // 16


def canonical_windows(codes: torch.Tensor, k: int):
    """All canonical k-mer windows of a code tile.

    ``codes``: integer tensor ``[..., L]`` of base codes in {0..4}.
    Returns (keys: tuple of W int64 tensors ``[..., P]``, valid: bool
    ``[..., P]``) with ``P = L - k + 1`` window positions."""
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"tile length {L} < k={k}")
    c = codes.to(torch.int64)

    def pack(w: int, rc: bool):
        acc = torch.zeros(codes.shape[:-1] + (P,), dtype=torch.int64, device=codes.device)
        nb = min(16, k - 16 * w)
        for j in range(nb):
            i = 16 * w + j
            acc <<= 2
            if rc:
                # complement 3 - c; invalid codes (4) wrap to 3 as in u32
                acc |= (3 - c[..., k - 1 - i: k - 1 - i + P]) & 3
            else:
                acc |= c[..., i: i + P]
        acc <<= 2 * (16 - nb)             # trailing word left-aligned
        return acc & M32

    W = words_per_kmer(k)
    fwd = [pack(w, False) for w in range(W)]
    rcw = [pack(w, True) for w in range(W)]
    # lexicographic forward <= reverse complement (ties -> forward): the
    # most significant differing word decides
    carry = torch.zeros_like(fwd[0])
    for f, r in zip(reversed(fwd), reversed(rcw)):
        carry = torch.where(f < r, -1, torch.where(f > r, 1, carry))
    keys = tuple(torch.where(carry <= 0, f, r) for f, r in zip(fwd, rcw))

    # window validity: no code >= 4 inside [t, t + k)
    cs = torch.cumsum((codes >= 4).to(torch.int32), dim=-1)
    cs0 = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    valid = (cs0[..., k: k + P] - cs0[..., :P]) == 0
    return keys, valid


def windows_with_hash(codes: torch.Tensor, k: int):
    """Canonical windows and their slot hash, flattened over the leading
    dimensions: (keys: tuple of W int64 ``[N]``, valid bool ``[N]``, h
    int64 ``[N]`` in [0, 2^32))."""
    keys, valid = canonical_windows(codes, k)
    keys = tuple(kw.reshape(-1) for kw in keys)
    return keys, valid.reshape(-1), hash_words(keys)
