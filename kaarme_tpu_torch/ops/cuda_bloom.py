"""B1 and B2: the two-stage Bloom prefilter of ``-b`` on the card — the
counterparts of the JAX package's XLA ops (not Pallas kernels):
``kaarme_tpu/ops/bloom.py::insert_batch`` with the validity mask and
``hashing.hash_words64`` in front of it (the pass-1 insert, B1), and
``kaarme_tpu/ops/sortcount.py::_bloom_miss_mask`` applied as
``keys | miss`` (the pass-2 gate, B2).

``bloom_insert`` and ``bloom_gate`` launch the hand-written kernels
(``csrc/bloom.cu``: the roots and validity from the key columns in
registers; B1 decides every key against the filters as they stood
before the batch, filter-first, ranking in a scratch set only the roots
not already in both stages, then sets; B2 overwrites a missed key with
all-ones) on CUDA tensors, and run their
plain PyTorch versions, ``bloom_insert_plain`` and ``bloom_gate_plain``,
on CPU tensors.  The plain versions are the definitions: the torch
validity and ``hashing.hash_words64``, then ``ops/bloom.insert_batch``
(held to the JAX package bit for bit) or the membership test
``ops/bloom.contains``.

Contract (both versions): ``bf1``, ``bf2`` int32 words holding u32 bit
patterns, a power of two of them, one device; ``keys`` a sequence of W
columns of N values (int32 bit patterns, or int64 in [0, 2^32)), a
window valid unless every word is all-ones.  ``bloom_insert`` updates
the filters in place and returns (new_in_first, new_in_second), 0-d
int64 tensors on the filters' device, and makes no host
synchronisation on the card.  ``bloom_gate`` overwrites, in place,
every word of each valid key whose ``hfn`` bits are not all set in
``bf2`` with all-ones, and returns the keys.  The kernels read key
columns that are views of one int32 buffer (K3's ``(W, N)`` output) where
they lie and stack others (``cuda_table._key_columns``); ``bloom_gate``
then gates and returns the stacked copy's rows.  ``scratch_for`` makes
B1's scratch (``BloomScratch``), which a caller allocates once per pass
and passes to every batch: its scratch set is zeroed once, and each batch
takes the next epoch instead of clearing it (``csrc/bloom.cu``).
"""

from __future__ import annotations

import torch

from . import _build
from .bloom import contains, insert_batch
from .cuda_table import _key_columns
from .hashing import hash_words64
from .sortcount import M32, _is_sentinel_i32, i32


def _slots(n: int) -> int:
    """B1's scratch-set slots for n windows: a power of two >= 2n."""
    return 1 << max(2 * n - 1, 1).bit_length()


def _scratch_words(n: int) -> int:
    """int32 words of B1's scratch: 4 per slot (16 B: state, count, r1,
    r2), then the decisions, two words per 32 windows."""
    return 4 * _slots(n) + 2 * -(-n // 32)


# Epochs a scratch set counts before it is zeroed again (state = epoch << 1
# | published must fit a u32; 0 means a slot never used).
EPOCH_MAX = (1 << 31) - 1


class BloomScratch:
    """B1's scratch for batches of up to ``n`` windows: one zeroed int32
    buffer, the set's ``slots`` 16 B slots then the decisions, and the
    epoch of the last batch that used it.  ``next_epoch`` gives each
    batch its epoch and says when the set must be zeroed first (the wrap
    from ``EPOCH_MAX`` to 1); set ``epoch`` to start elsewhere."""

    def __init__(self, n: int, device):
        self.n = n
        self.slots = _slots(n)
        self.buf = torch.zeros(_scratch_words(n), dtype=torch.int32, device=device)
        self.epoch = 0

    def next_epoch(self):
        """(epoch, clear) for the next batch."""
        clear = self.epoch >= EPOCH_MAX
        self.epoch = 1 if clear else self.epoch + 1
        return self.epoch, clear


def scratch_for(n: int, device, have: "BloomScratch | None" = None):
    """B1's scratch for batches of up to n windows on ``device``: ``have``
    when it is large enough, else a new one; None off a card (the plain
    version needs none)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if have is not None and have.n >= n:
        return have
    return BloomScratch(n, device)


def _check(bf, keys, hfn: int, *others):
    for b in (bf,) + others:
        if b.dim() != 1 or b.dtype != torch.int32 or not b.is_contiguous():
            raise ValueError("a Bloom filter must be a contiguous 1-d int32 tensor")
        if b.shape != bf.shape:
            raise ValueError("the two filters must have one size")
    nwords = bf.shape[0]
    if nwords < 1 or nwords & (nwords - 1) or nwords > (1 << 32):
        raise ValueError(f"a filter holds a power of two <= 2^32 words, got {nwords}")
    if hfn < 0:
        raise ValueError("hfn must be >= 0")
    if not len(keys) or keys[0].dim() != 1:
        raise ValueError("keys must be a non-empty sequence of (N,) columns")
    n = keys[0].shape[0]
    if any(k.shape != (n,) for k in keys):
        raise ValueError("every key column must be (N,)")
    if any(t.device != bf.device for t in list(keys) + list(others)):
        raise ValueError("the filters and the keys must be on one device")
    return nwords, n


def _device_of(bf):
    if bf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bf.device}")
    return bf.device


def bloom_insert(bf1: torch.Tensor, bf2: torch.Tensor, keys, hfn: int,
                 scratch: "BloomScratch | None" = None):
    """Pass-1 insert of a batch of key columns (module docstring): B1 on
    the card, ``bloom_insert_plain`` on the CPU.  ``scratch`` is a
    ``BloomScratch`` for n windows or more (``scratch_for``; allocated here
    when None); the batch takes its next epoch."""
    nwords, n = _check(bf1, keys, hfn, bf2)
    if _device_of(bf1).type == "cpu":
        return bloom_insert_plain(bf1, bf2, keys, hfn)
    dev = bf1.device
    if not n:
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return zero, zero.clone()
    counters = torch.empty(2, dtype=torch.int64, device=dev)
    kbuf, lw, li = _key_columns(keys)
    scratch = scratch_for(n, dev, scratch)
    if scratch.buf.device != dev:
        raise ValueError("the scratch must be on the filters' device")
    epoch, clear = scratch.next_epoch()
    dec = scratch.buf[4 * scratch.slots:]
    with torch.cuda.device(dev):
        err = _build.lib().kt_bloom_insert(
            bf1.data_ptr(), bf2.data_ptr(), nwords, hfn, kbuf.data_ptr(), lw, li, len(keys), n,
            scratch.buf.data_ptr(), scratch.slots, epoch, int(clear), dec.data_ptr(),
            counters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_bloom_insert")
    bloom_insert.launches += 1
    return counters[0], counters[1]


bloom_insert.launches = 0


def bloom_insert_plain(bf1: torch.Tensor, bf2: torch.Tensor, keys, hfn: int):
    """Plain PyTorch version of ``bloom_insert``: the torch validity and
    ``hash_words64``, then ``ops/bloom.insert_batch`` (the JAX package's
    semantics), written back into the filters."""
    _check(bf1, keys, hfn, bf2)
    valid = _is_sentinel_i32([i32(k) for k in keys]) == 0
    r1, r2 = hash_words64(keys)
    b1, b2, n1, n2 = insert_batch(bf1, bf2, r1, r2, valid, hfn)
    bf1.copy_(b1)
    bf2.copy_(b2)
    return n1, n2


def bloom_gate(bf2: torch.Tensor, keys, hfn: int) -> tuple:
    """Pass-2 gate of a batch of key columns (module docstring): B2 on
    the card, ``bloom_gate_plain`` on the CPU.  Returns the gated keys."""
    nwords, n = _check(bf2, keys, hfn)
    if _device_of(bf2).type == "cpu":
        return bloom_gate_plain(bf2, keys, hfn)
    if not n:
        return tuple(keys)
    dev = bf2.device
    kbuf, lw, li = _key_columns(keys)
    with torch.cuda.device(dev):
        err = _build.lib().kt_bloom_gate(bf2.data_ptr(), nwords, hfn, kbuf.data_ptr(), lw, li,
                                         len(keys), n, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_bloom_gate")
    bloom_gate.launches += 1
    if kbuf is keys[0]:
        return tuple(keys)
    return tuple(kbuf.unbind(0))


bloom_gate.launches = 0


def bloom_gate_plain(bf2: torch.Tensor, keys, hfn: int) -> tuple:
    """Plain PyTorch version of ``bloom_gate``: ``hash_words64`` and one
    ``ops/bloom.contains`` gather per key; a missed key's words become
    all-ones in place (-1 in an int32 column, 2^32 - 1 in an int64 one)."""
    _check(bf2, keys, hfn)
    r1, r2 = hash_words64(keys)
    miss = ~contains(bf2, r1, r2, hfn)
    return tuple(k.masked_fill_(miss, -1 if k.dtype == torch.int32 else M32) for k in keys)
