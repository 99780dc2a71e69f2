"""Store, unpack, sort and compaction helpers of the sort backend and
the classic pipeline's supersteps, in PyTorch (counterpart of
``kaarme_tpu/ops/sortcount.py``).

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
    """int32 [n] codes: base 0..3 in bits 0-1, bit 2 set where the
    invalid bitmap marks the position."""
    x = _unpack_bases(packed, n)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    m = ((maskwords[:, None] >> shifts) & 1).reshape(-1)[:n]
    return x | (m << 2)


def codes_from_chunk(packed, sep, *, k: int, n: int) -> torch.Tensor:
    """Transfer chunk (2-bit words + separator bitmap) -> the n + k - 1
    codes of an n-window superstep."""
    return unpack_codes(packed, sep, n + k - 1)


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

def sort_key(cols) -> torch.Tensor:
    """One or two int32 bit-pattern columns as one int64 key whose signed
    order is their unsigned order, (hi, lo) lexicographic for two: (hi -
    2^31) * 2^32 + lo, or the one column's unsigned value."""
    if len(cols) == 2:
        return (u32(cols[0]) - (1 << 31)) * (1 << 32) + u32(cols[1])
    return u32(cols[0])


def lexsort(cols, num_keys: int) -> torch.Tensor:
    """Sort rows by the first ``num_keys`` int32 bit-pattern columns
    (most significant first, unsigned order); the remaining columns ride
    along.  Returns the sorted columns stacked as one (len(cols), N)
    int32 tensor.

    The counterpart of ``lax.sort(cols, num_keys=...)``: column pairs
    pack into one int64 key (``sort_key``), and stable ``torch.sort``
    passes run least-significant pair first, composing one permutation.
    Rows with equal keys keep their input order."""
    perm = None
    j = num_keys
    while j > 0:
        i = max(j - 2, 0)
        part = [c if perm is None else c[perm] for c in cols[i:j]]
        key = sort_key(part)
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

    check_kernels(kernels)
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
# Classic pipeline: one row per window (K3 keys, then sort + K2 or K4)
# ---------------------------------------------------------------------------

def embed_bits(k: int) -> int:
    """Free low bits in the (left-aligned) trailing key word."""
    r = k % 16
    return 2 * (16 - r) if r else 0


def check_kernels(kernels: str):
    if kernels not in ("cuda", "plain"):
        raise ValueError(f"kernels must be 'cuda' or 'plain', got {kernels!r}")


def window_keys_from_chunk(packed, sep, *, k: int, n: int, kernels: str = "cuda",
                           bloom=None, hfn: int = 0) -> tuple:
    """Transfer chunk -> the n canonical window keys, unsorted (W int32
    columns; invalid windows are all-ones): K3 straight from the chunk
    (``kernels="cuda"``), or the unpack then the plain K3 (``"plain"``).
    With a Bloom filter ``bloom`` (int32 words, ``hfn`` bits per key),
    keys that miss it become all-ones too, so they drop out of the merge
    as invalid windows do (``bloom_gate``: B2 or its plain version).  The
    counterpart of ``sortcount._keys_from_chunk`` plus the supersteps'
    ``_bloom_miss_mask`` gate."""
    from . import cuda_winkeys

    check_kernels(kernels)
    if kernels == "cuda":
        keys = cuda_winkeys.window_keys(packed, sep, k=k, n=n)
    else:
        keys = cuda_winkeys.window_keys_torch(codes_from_chunk(packed, sep, k=k, n=n), k, n)
    if bloom is not None:
        keys = bloom_gate(bloom, keys, hfn, kernels)
    return keys


def superstep_embedded(packed, sep, prefix, *, k: int, n: int, ebits: int,
                       kernels: str = "cuda", bloom=None, hfn: int = 0):
    """Classic superstep with the count embedded in the trailing key
    word's low ``ebits`` (>= 21): window keys (|1, a count of one) ++
    the prefix (its count ORed into its last word), one W-column sort,
    K2 embedded.  Returns (W key columns + count column, each cut to the
    prefix capacity, int32 [nd_exact, nd_used]); nd > capacity means
    the store overflowed.  ``bloom``/``hfn``: the pass-2 gate of
    ``window_keys_from_chunk``."""
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    keys = window_keys_from_chunk(packed, sep, k=k, n=n, kernels=kernels, bloom=bloom, hfn=hfn)
    cols = [torch.cat([prefix[i], keys[i]]) for i in range(w - 1)]
    cols.append(torch.cat([prefix[w - 1] | prefix[-1], keys[w - 1] | 1]))
    return _kernel_finish(lexsort(cols, num_keys=w), cap, True, ebits, kernels)


def superstep_plain(packed, sep, prefix, *, k: int, n: int, kernels: str = "cuda",
                    bloom=None, hfn: int = 0):
    """Classic superstep for k without 21 free trailing-word bits: the
    count rides the sort as a separate column (not a sort key) and K2's
    full_sum mode sums each key's rows.  That is the reference's XLA
    route (``compact``) on every input, and its Pallas route (the c_last
    mode, which needs at most one non-unit row per key) wherever that
    precondition holds — which every caller guarantees: the prefix holds
    one row per key and window rows count one.  Same contract as
    ``superstep_embedded``."""
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    keys = window_keys_from_chunk(packed, sep, k=k, n=n, kernels=kernels, bloom=bloom, hfn=hfn)
    cols = [torch.cat([prefix[i], keys[i]]) for i in range(w)]
    cnt = torch.cat([prefix[-1], torch.ones(n, dtype=torch.int32, device=prefix[-1].device)])
    return _kernel_finish(lexsort(cols + [cnt], num_keys=w), cap, False, 0, kernels)


def superstep_merged(packed, sep, prefix, *, k: int, n: int, ebits: int = 0,
                     kernels: str = "cuda", bloom=None, hfn: int = 0):
    """Linear-merge superstep (``--compactor merge``): sort only the n
    window keys, then merge them with the already sorted, dense prefix
    in one linear pass fused with the compaction (K4).  Embedded layout
    when ``ebits`` >= 21, separate count otherwise.  Same contract as
    ``superstep_embedded``."""
    from . import cuda_merge

    check_kernels(kernels)
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    embedded = ebits >= 21
    keys = list(window_keys_from_chunk(packed, sep, k=k, n=n, kernels=kernels, bloom=bloom,
                                       hfn=hfn))
    if embedded:
        keys[w - 1] |= 1        # in place: the window keys are a fresh buffer
        a = torch.stack(list(prefix[:w - 1]) + [prefix[w - 1] | prefix[-1]])
    else:
        a = torch.stack(list(prefix))
    b = lexsort(keys, num_keys=w)
    fn = cuda_merge.merge_compact if kernels == "cuda" else cuda_merge.merge_compact_torch
    okeys, ocnt, ndv = fn(a, b, embedded=embedded, ebits=ebits if embedded else 0,
                          out_len=cap)
    return tuple(okeys.unbind(0)) + (ocnt,), ndv


# ---------------------------------------------------------------------------
# Two-pass Bloom prefilter on the sort backend
# ---------------------------------------------------------------------------
# The reference's -b mode: pass 1 streams the input through BF1/BF2 (seen
# once / seen twice), pass 2 counts only windows whose key hits BF2.
# Here a missing key turns into the all-ones sentinel row before the
# sort, exactly like an invalid window (``window_keys_from_chunk``).

def bloom_gate(bf2, keys, hfn: int, kernels: str = "cuda") -> tuple:
    """The pass-2 gate: every word of a key whose hfn Bloom bits are NOT
    all set in ``bf2`` becomes all-ones, in place (the reference's
    ``_bloom_miss_mask`` ORed into the keys).  ``kernels``: "cuda" -> B2's
    wrapper (``cuda_bloom.bloom_gate``: the kernel on CUDA tensors, its
    plain version on CPU ones), "plain" -> the plain version everywhere.
    Returns the gated key columns."""
    from . import cuda_bloom

    check_kernels(kernels)
    fn = cuda_bloom.bloom_gate if kernels == "cuda" else cuda_bloom.bloom_gate_plain
    return fn(bf2, keys, hfn)


def bloom_pass1_superstep(bf1, bf2, packed, sep, *, k: int, n: int, hfn: int = 4,
                          kernels: str = "cuda", scratch=None):
    """Pass-1 superstep: window keys from the chunk (K3) -> BF1/BF2 insertion
    of every valid window's root hash, in place: B1 (``cuda_bloom.
    bloom_insert``, given ``scratch`` from ``cuda_bloom.scratch_for``) under
    ``kernels="cuda"``, its plain version (the torch hash and
    ``bloom.insert_batch``) under "plain".  Returns (bf1, bf2,
    new_in_first, new_in_second), the counters as 0-d int64 tensors; no
    host synchronisation on the kernel route."""
    from . import cuda_bloom

    keys = window_keys_from_chunk(packed, sep, k=k, n=n, kernels=kernels)
    if kernels == "cuda":
        n1, n2 = cuda_bloom.bloom_insert(bf1, bf2, keys, hfn, scratch)
    else:
        n1, n2 = cuda_bloom.bloom_insert_plain(bf1, bf2, keys, hfn)
    return bf1, bf2, n1, n2


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
