"""Open-addressing canonical k-mer count table in device memory, in
PyTorch — the counterpart of ``kaarme_tpu/ops/table.py``.

Layout: keys ``(C, W)`` int32 rows holding u32 bit patterns and counts
``(C,)`` int32, C a power of two; an empty slot is count 0.  A key's
probe chain is (h + i(i+1)/2) & (C - 1), i < ``max_probes`` (the
triangular sequence, a full cycle modulo 2^m), with h the murmur3 hash
of its words (``ops/hashing.hash_words``), so occupancy and the grow
policy mean what they mean in the JAX package.

``insert`` takes ``kernels``: ``"cuda"`` runs T1 (``cuda_table``: the
atomic insert kernel on CUDA tensors, which derives validity and the
slot hash from the key words itself; its plain version on CPU ones),
``"plain"`` the plain version (the torch validity and hash, then the
JAX package's probe rounds) on any device.  A full table does not abort: unresolved windows come back in
``pending`` and the counter grows the table and retries
(models/counter.py).  ``lookup`` is plain PyTorch probe rounds: it
serves ``find``, off the counting path.

The counting step takes a batch as its transfer chunk (2-bit words and
the separator bitmap, ``models/sort_counter.pack_chunk``), whose window keys K3
makes as it does for the classic pipeline; an invalid window's key is
all-ones in every word, which no canonical key is, so that is the
validity mask, and the step hands T1 the key columns alone.  Valid
windows get the keys ``ops/windows`` gives the JAX package's code tiles
(the same windows in the same order), so the plain insert places them
as the JAX table does.
"""

from __future__ import annotations

import torch

from . import sortcount
from .cuda_table import _tri, table_insert, table_insert_plain
from .sortcount import M32, i32


def make_table(capacity_log2: int, words: int, device):
    """A fresh table on ``device``: (keys (C, W) int32, counts (C,) int32)."""
    c = 1 << capacity_log2
    return (torch.zeros((c, words), dtype=torch.int32, device=device),
            torch.zeros((c,), dtype=torch.int32, device=device))


def insert(tkeys, counts, keys, valid=None, h=None, amount=None, max_probes: int = 64,
           kernels: str = "cuda"):
    """Insert/accumulate a batch of canonical k-mers (``cuda_table``'s
    contract: ``valid`` and ``h`` None are derived from the key words;
    the table is updated in place).  Returns (tkeys, counts,
    pending, n_pending): pending marks the valid windows that did not
    land within ``max_probes`` probes, n_pending is their number as a
    0-d int32 tensor on the table's device (the kernel counts them as it
    goes)."""
    sortcount.check_kernels(kernels)
    run = table_insert if kernels == "cuda" else table_insert_plain
    pending, n_pending = run(tkeys, counts, keys, valid, h, amount, max_probes=max_probes)
    return tkeys, counts, pending, n_pending


def lookup(tkeys, counts, keys, h, max_probes: int = 64) -> torch.Tensor:
    """Point lookup: int32 count per key (0 if absent); an empty slot
    ends a key's probe chain."""
    c = tkeys.shape[0]
    kmat = torch.stack([i32(k) for k in keys], 1)
    n = kmat.shape[0]
    hv = h.to(torch.int64) & M32
    pending = torch.ones(n, dtype=torch.bool, device=tkeys.device)
    probe = torch.zeros(n, dtype=torch.int64, device=tkeys.device)
    out = torch.zeros(n, dtype=torch.int32, device=tkeys.device)
    for _ in range(max_probes):
        if not bool(pending.any()):
            break
        slot = (hv + _tri(probe)) & (c - 1)
        g_cn = counts[slot]
        occupied = g_cn > 0
        key_eq = (tkeys[slot] == kmat).all(1)
        out = torch.where(pending & occupied & key_eq, g_cn, out)
        pending &= occupied & ~key_eq
        probe += pending
    return out


def count_step(tkeys, counts, packed, sep, *, k: int, n: int, max_probes: int = 64,
               kernels: str = "cuda", bloom=None, hfn: int = 0):
    """One device step: a batch's transfer chunk -> its key columns (K3,
    ``sortcount.window_keys_from_chunk``; ``bloom``/``hfn``: keys that
    miss the Bloom filter come back all-ones too) -> insert (T1, which
    derives validity and the slot hash from them).  Returns (tkeys, counts, n_overflow:
    0-d int32 tensor, pending): pending is the exact per-window
    unresolved mask, so a grow-and-retry re-inserts only what did not
    land."""
    keys = sortcount.window_keys_from_chunk(packed, sep, k=k, n=n, kernels=kernels,
                                            bloom=bloom, hfn=hfn)
    tkeys, counts, pending, n_pending = insert(tkeys, counts, keys, max_probes=max_probes,
                                               kernels=kernels)
    return tkeys, counts, n_pending, pending
