"""Two-stage blocked Bloom prefilter, in PyTorch — the counterpart of
``kaarme_tpu/ops/bloom.py``, bit for bit: the same words, the same bits
and the same exactly-once counters for the same batches.

BF1 = "seen at least once", BF2 = "seen at least twice".  Pass 1 of the
two-pass ``-b`` mode inserts every valid window's root hash (r1, r2)
batch by batch; the store is sized from BF2's counter, BF1 is dropped
and pass 2 counts only keys whose bits are all set in BF2.

Layout: all ``hfn`` bits of a key live in ONE 32-bit word (word index
from r1, bit positions from r2 with an odd stride, so the bits are
distinct), so membership is one gather.  A filter is an int32 tensor of
words holding uint32 bit patterns (``utils.convert.bloom_to_torch``
carries a JAX filter over).

The JAX package sorts (word, mask) pairs and OR-combines them with a
segmented scan because the TPU has no cheap scatter-OR.  PyTorch has no
scatter-OR either, so ``set_bits`` scatters into a bit plane (one bool
per filter bit; duplicate writes all write True) and packs it back into
words.  ``insert_batch`` ranks duplicate keys within a batch by
``torch.unique`` counts instead of an in-segment ordinal; both are
exact, so the results are the JAX package's.  These are the plain
definitions: on the card the pass-1 insert and the pass-2 gate run as
the kernels B1 and B2 (``ops/cuda_bloom.py``), held to them.
"""

from __future__ import annotations

import torch

from .sortcount import M32, u32

# Extra bits per stage over the reference formula, buying back the
# blocked layout's false-positive inflation (kaarme_tpu/ops/bloom.py).
BLOCK_COMPENSATION = 4


def make_bloom(bits: int, device) -> torch.Tensor:
    """One stage's bit array as int32 words on ``device``; ``bits`` is a
    power of two."""
    if bits % 32 or bits & (bits - 1):
        raise ValueError(f"bits must be a power of two >= 32, got {bits}")
    return torch.zeros(bits // 32, dtype=torch.int32, device=device)


def _word_mask(r1, r2, hfn: int, nwords: int):
    """Blocked addressing: (word index, hfn-bit mask), int64.  Bit j sits
    at (b0 + j * stride) mod 32 with an ODD stride, a permutation of the
    32 positions, so the hfn (< 32) bits are distinct."""
    w = r1 & (nwords - 1)
    b0 = r2 & 31
    stride = ((r2 >> 5) | 1) & 31
    mask = torch.zeros_like(r2)
    for j in range(hfn):
        mask |= 1 << ((b0 + j * stride) & 31)
    return w, mask


def contains(bf: torch.Tensor, r1, r2, hfn: int) -> torch.Tensor:
    """bool: every one of the key's hfn bits is set in ``bf``."""
    w, mask = _word_mask(r1, r2, hfn, bf.shape[0])
    return (u32(bf[w]) & mask) == mask


def set_bits(bf: torch.Tensor, r1, r2, hfn: int, active) -> torch.Tensor:
    """``bf`` with all hfn bits of every active key set — exact: every
    bit lands, however many keys share a word."""
    nwords = bf.shape[0]
    w, _ = _word_mask(r1, r2, hfn, nwords)
    act = active.bool()
    w, r2 = w[act], r2[act]
    b0, stride = r2 & 31, ((r2 >> 5) | 1) & 31
    plane = torch.zeros(nwords * 32, dtype=torch.bool, device=bf.device)
    for j in range(hfn):
        plane[w * 32 + ((b0 + j * stride) & 31)] = True
    # bit i of word v is plane[32 v + i]: pack 8 bits per byte, and the
    # four little-endian bytes of word v are bytes 4v .. 4v + 3
    weights = (1 << torch.arange(8, device=bf.device)).to(torch.uint8)
    byte = (plane.view(-1, 8).to(torch.uint8) * weights).sum(1, dtype=torch.uint8)
    return bf | byte.view(torch.int32)


def insert_batch(bf1: torch.Tensor, bf2: torch.Tensor, r1, r2, valid, hfn: int):
    """Pass-1 insertion of a batch of root hashes (int64 in [0, 2^32)).

    A valid key sets BF1 on its first occurrence when BF1 did not hold
    it, and BF2 when it was not yet in BF2 and either BF1 already held
    it (seen in an earlier batch) or the batch holds it twice.  Returns
    (bf1, bf2, new_in_first, new_in_second): the counters count keys,
    each once, as int64 tensors (the reference's exactly-once counters
    that size the store)."""
    v = valid.bool()
    key = (r1[v] - (1 << 31)) * (1 << 32) + r2[v]           # unique (r1, r2) order
    uk, cnt = torch.unique(key, return_counts=True)
    ur1, ur2 = (uk >> 32) + (1 << 31), uk & M32
    in1 = contains(bf1, ur1, ur2, hfn)
    in2 = contains(bf2, ur1, ur2, hfn)
    set1 = ~in1
    set2 = ~in2 & (in1 | (cnt >= 2))
    return (set_bits(bf1, ur1, ur2, hfn, set1), set_bits(bf2, ur1, ur2, hfn, set2),
            set1.sum(), set2.sum())

