"""Store, unpack, sort and compaction helpers of the sort backend, in
PyTorch (counterpart of ``kaarme_tpu/ops/sortcount.py``, the subset the
super-k-mer main path runs).

Word layout: every key column is an ``int32`` tensor holding the uint32
bit pattern (PyTorch lacks most uint32 arithmetic); kernels read it as
``uint32_t``.  Plain code widens with :func:`u32` (int64 in [0, 2^32))
wherever it orders, shifts or compares, and narrows back with
:func:`i32`.  The all-ones sentinel is -1 as int32, which would sort
FIRST as a signed value: ``lexsort`` orders by the unsigned pattern, so
dead rows sort last as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern column -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns (wrapping cast)."""
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# Device-side unpack of the host transfer format (fastio.pack_stream)
# ---------------------------------------------------------------------------

def _unpack_bases(packed: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=packed.device)
    return ((packed[:, None] >> shifts) & 3).reshape(-1)[:n]


def unpack_codes(packed: torch.Tensor, maskwords: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [n] codes: base 0..3 in bits 0-1, bit 2 set where the dense
    invalid bitmap marks the position."""
    x = _unpack_bases(packed, n)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    m = ((maskwords[:, None] >> shifts) & 1).reshape(-1)[:n]
    return x | (m << 2)


def unpack_codes_sparse(packed: torch.Tensor, sep_idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [n] codes with code 4 at every separator index.  Indices
    outside [0, n) are dropped, as the reference's ``mode="drop"``
    scatter drops its out-of-range padding."""
    x = _unpack_bases(packed, n)
    sep = sep_idx.to(torch.int64)
    sep = sep[(sep >= 0) & (sep < n)]
    x[sep] = 4
    return x


# ---------------------------------------------------------------------------
# Word helpers
# ---------------------------------------------------------------------------

def _pairrev32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of each word (int64 in [0, 2^32)):
    little-endian transfer packing <-> big-endian key packing."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return ((x << 16) | (x >> 16)) & M32


def _clamp_count(c: torch.Tensor) -> torch.Tensor:
    """Modular clamp c > 2^20 -> 2^20 + (c mod 2^20): keeps both output
    contracts (14-bit saturation, uint16 wrap) and every stored count
    below 2^21 (see kaarme_tpu/ops/sortcount.py::_clamp_count)."""
    big = 1 << 20
    return torch.where(c > big, big + (c & (big - 1)), c)


def _is_sentinel_i32(keys) -> torch.Tensor:
    """int32 1 where every key word of the row is all-ones."""
    acc = keys[0]
    for x in keys[1:]:
        acc = acc & x
    return (acc == -1).to(torch.int32)


def make_store(cap: int, words: int, device) -> tuple:
    """``words`` sentinel key columns + one zero int32 count column."""
    return tuple(torch.full((cap,), -1, dtype=torch.int32, device=device)
                 for _ in range(words)) + \
        (torch.zeros((cap,), dtype=torch.int32, device=device),)


def dead_fill(n: int, is_count: bool, device) -> torch.Tensor:
    """Padding rows for a store column: sentinel keys, zero counts."""
    return torch.full((n,), 0 if is_count else -1, dtype=torch.int32, device=device)


def next_store_size(x: int, coarse: bool = False) -> int:
    """Smallest {2^m, 3*2^m} (m >= 12) value >= x; ``coarse`` keeps
    powers of two only above 2^22 (the reference's store ladder)."""
    x = max(int(x), 1 << 12)
    p = 1 << (x - 1).bit_length()
    if coarse and x > (1 << 22):
        return p
    return 3 * p // 4 if 3 * p // 4 >= x else p


# ---------------------------------------------------------------------------
# Multi-word lexicographic sort
# ---------------------------------------------------------------------------

def lexsort(cols, num_keys: int) -> torch.Tensor:
    """Sort rows by the first ``num_keys`` int32 bit-pattern columns
    (most significant first, unsigned order); the remaining columns ride
    along.  Returns the sorted columns stacked as one (len(cols), N)
    int32 tensor.

    The counterpart of ``lax.sort(cols, num_keys=...)``: column pairs
    pack into one int64 key ((hi - 2^31) * 2^32 + lo, whose signed order
    is the unsigned (hi, lo) order), and stable ``torch.sort`` passes run
    least-significant pair first, composing one permutation.  Rows with
    equal keys keep their input order."""
    perm = None
    j = num_keys
    while j > 0:
        i = max(j - 2, 0)
        part = [c if perm is None else c[perm] for c in cols[i:j]]
        if len(part) == 2:
            key = (u32(part[0]) - (1 << 31)) * (1 << 32) + u32(part[1])
        else:
            key = u32(part[0])
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
        j = i
    stacked = torch.stack(list(cols))
    return stacked if perm is None else stacked[:, perm]


# ---------------------------------------------------------------------------
# Compaction after the sort (K2)
# ---------------------------------------------------------------------------

def _kernel_finish(sorted_cols: torch.Tensor, cap: int, embedded: bool,
                   ebits: int, kernels: str):
    """Post-sort half of a merge on K2 (counterpart of
    ``sortcount._pallas_finish``).  ``sorted_cols`` is the (C, N) output
    of ``lexsort``: W key columns with the count embedded in the last
    one's low ``ebits`` (``embedded``), or W key columns plus a count
    column (full_sum mode).  Returns (W key columns + int32 count column,
    each (cap,), int32 [nd_exact, nd_used]); rows past nd are sentinels
    with count 0, and nd > cap means the capacity overflowed.  ``kernels``:
    "cuda" -> the K2 wrapper (the kernel on CUDA tensors, its plain
    version on CPU ones), "plain" -> the plain version everywhere."""
    from . import cuda_compact

    if kernels not in ("cuda", "plain"):
        raise ValueError(f"kernels must be 'cuda' or 'plain', got {kernels!r}")
    fn = cuda_compact.segsum_compact if kernels == "cuda" else cuda_compact.segsum_compact_torch
    if embedded:
        okeys, ocnt, ndv = fn(sorted_cols, None, ebits=ebits, out_len=cap)
    else:
        okeys, ocnt, ndv = fn(sorted_cols[:-1], sorted_cols[-1], out_len=cap)
    return tuple(okeys.unbind(0)) + (ocnt,), ndv


def compact_clamped(store, kernels: str = "cuda"):
    """Sort store columns (W key columns + count column) and merge equal
    keys with the clamped segmented sum, exact for any number of rows
    per key (``sortcount.compact_clamped``).  Returns (W+1 columns of
    the input length, int32 [nd_exact, nd_used])."""
    keys = list(store[:-1])
    s = lexsort(keys + [store[-1]], num_keys=len(keys))
    return _kernel_finish(s, s.shape[1], False, 0, kernels)


# ---------------------------------------------------------------------------
# Host-side lookup
# ---------------------------------------------------------------------------

def lookup_sorted(keys_np: np.ndarray, cnt_np: np.ndarray, queries: np.ndarray):
    """Counts of (Q, W) uint32 query rows in a sorted (N, W) uint32 key
    array (0 where absent), narrowing a range column by column."""
    out = np.zeros(queries.shape[0], np.int64)
    n = keys_np.shape[0]
    if n == 0:
        return out
    for i in range(queries.shape[0]):
        lo, hi = 0, n
        for j in range(keys_np.shape[1]):
            col = keys_np[lo:hi, j]
            v = queries[i, j]
            lo, hi = lo + np.searchsorted(col, v, "left"), \
                lo + np.searchsorted(col, v, "right")
            if lo == hi:
                break
        if lo < hi:
            out[i] = int(cnt_np[lo])
    return out
