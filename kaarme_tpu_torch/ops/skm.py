"""Super-k-mer (minimizer-run) pipeline in PyTorch — the counterpart of
``kaarme_tpu/ops/skm.py``, the subset the main path runs.

Per superstep: segment the transfer chunk into run rows — dense (K1)
or slotted, S rows per 512-window tile (K5); both read the chunk
itself (``cuda_skm``) —
sort the run-store prefix ++ the new rows by their Wc + 1 words
(``sortcount.lexsort``) and merge equal rows with the embedded-count
segment-sum (K2, ``cuda_compact``, ebits = 26).  At finalize, every
distinct run expands into its canonical k-mer keys (E1,
``cuda_expand``), which are sorted and summed with K2's full_sum mode;
with a Bloom filter, keys that miss it become sentinels first (the
two-pass ``-b`` mode's gate on this pipeline).

``kernels`` ("cuda" or "plain") picks the hand-written kernels (their
plain versions on CPU tensors) or the plain versions everywhere.
"""

from __future__ import annotations

import torch

from ..utils import trace
from ..utils.codec import words_per_kmer
from . import cuda_skm
from .cuda_skm import EBITS, LMAX, M, content_words
from .sortcount import (M32, _is_sentinel_i32, _kernel_finish, _pairrev32, bloom_gate,
                        check_kernels, compact_clamped, dead_fill, i32, lexsort, make_store,
                        next_store_size, u32)


def store_words(k: int) -> int:
    """Run-store key columns: Wc content words + the meta word."""
    return content_words(k) + 1


def supported(k: int) -> bool:
    return k >= M


# ---------------------------------------------------------------------------
# Superstep: segmentation (K1 or K5) and merge (sort + K2)
# ---------------------------------------------------------------------------

def skm_segpack_dense_step(packed, sep, *, k: int, n: int, cap: int, kernels: str = "cuda"):
    """Transfer chunk -> dense run rows (Wc+1 columns of ``cap`` rows)
    and int32 [rows_exact, rows_used]: K1 reads the chunk itself."""
    fn = cuda_skm.run_rows_dense_plain if kernels == "plain" else cuda_skm.run_rows_dense
    return fn(packed, sep, k=k, n=n, cap=cap)


def skm_segpack_step(packed, sep, *, k: int, n: int, S: int, kernels: str = "cuda"):
    """Transfer chunk -> slotted run rows (Wc+1 columns of
    ceil(n / 512) * S rows) and int32 max_tile_runs: K5 reads the chunk
    itself."""
    fn = cuda_skm.run_rows_slotted_plain if kernels == "plain" else cuda_skm.run_rows_slotted
    return fn(packed, sep, k=k, n=n, S=S)


def _merge_slotted(rows, extra, prefix, kernels: str):
    """Merge run rows into the run store: sort prefix ++ rows by all
    Wc + 1 words (the prefix's count embedded in its meta word's low 26
    bits, new rows carry count 1) and segment-sum with K2.  Returns
    (the new store, cut to the prefix capacity, and int32
    [nd_exact, nd_used, *extra])."""
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    cols = [torch.cat([prefix[i], rows[i]]) for i in range(w - 1)]
    cols.append(torch.cat([prefix[w - 1] | prefix[-1], rows[w - 1]]))
    s = lexsort(cols, num_keys=w)
    out, ndv = _kernel_finish(s, cap, True, EBITS, kernels)
    return out, torch.cat([ndv, extra.reshape(-1).to(torch.int32)])


def skm_merge_step(slotted, maxruns, prefix, *, kernels: str = "cuda"):
    """Merge slotted run rows into the run store.  Returns (the new
    store, int32 [nd_exact, nd_used, max_tile_runs]); the caller replays
    with a larger S when max_tile_runs > S (rows were dropped)."""
    return _merge_slotted(slotted, maxruns, prefix, kernels)


def skm_merge_dense_step(rows, rows_nd, prefix, *, eff: int, kernels: str = "cuda"):
    """Merge the first ``eff`` dense run rows into the run store.  Rows
    at or past rows_used are sentinels, so any eff >= rows_used is
    exact; the caller checks rows_used <= eff in the returned
    [nd_exact, nd_used, rows_exact, rows_used] and replays otherwise."""
    return _merge_slotted(tuple(c[:eff] for c in rows), rows_nd, prefix, kernels)


# ---------------------------------------------------------------------------
# Finalize: expand distinct runs into canonical window keys
# ---------------------------------------------------------------------------

def _expand_keys(cw, ell, k: int):
    """Distinct run rows -> canonical window keys for every slot.

    cw: Wc int64 (R,) content words in [0, 2^32); ell int64 (R,).
    Returns W int64 (R * LMAX,) columns, slot-major within each run (row
    r*LMAX + e is window e of run r), sentinel where e >= ell: big-endian
    2-bit keys, min(forward, reverse complement), ties to forward."""
    W = words_per_kmer(k)
    Wc = len(cw)
    R = cw[0].shape[0]
    r = k % 16
    topmask = M32 if r == 0 else ((1 << (2 * r)) - 1) << (32 - 2 * r)
    zero = torch.zeros(R, dtype=torch.int64, device=cw[0].device)

    def word_at(o: int):
        """Big-endian 16-base word at span offset o (out-of-span bases
        read as 0 and only land in masked bits)."""
        if o < 0:
            return cw[0] >> (2 * -o) if -o < 16 else zero
        q, p = divmod(o, 16)
        a = cw[q] if q < Wc else zero
        if p == 0:
            return a
        bx = cw[q + 1] if q + 1 < Wc else zero
        return ((a << (2 * p)) & M32) | (bx >> (32 - 2 * p))

    slots = []
    for e in range(LMAX):
        fwd, rcw = [], []
        for wi in range(W):
            f = word_at(e + 16 * wi)
            g = _pairrev32(~word_at(e + k - 16 * (wi + 1)) & M32)
            if wi == W - 1:
                f, g = f & topmask, g & topmask
            fwd.append(f)
            rcw.append(g)
        carry = torch.zeros(R, dtype=torch.int64, device=zero.device)
        for f, g in zip(reversed(fwd), reversed(rcw)):
            carry = torch.where(f < g, -1, torch.where(f > g, 1, carry))
        slots.append([torch.where(carry <= 0, f, g) for f, g in zip(fwd, rcw)])

    dead = torch.arange(LMAX, device=zero.device)[None, :] >= ell[:, None]
    return tuple(torch.stack([slots[e][wi] for e in range(LMAX)], 1)
                 .masked_fill(dead, M32).reshape(-1) for wi in range(W))


def expand_runs_plain(run_cols, k: int) -> tuple:
    """Plain PyTorch version of E1 (``cuda_expand.expand_runs``), its
    definition: (Wc content cols, meta col, count col) -> W int32 key
    columns + int32 count column over R * LMAX rows, unsorted; dead run
    rows (count <= 0) and slots past ell are sentinel keys with count 0."""
    *cw, meta, cnt = run_cols
    ell = ((u32(meta) >> EBITS) & 15) + 1
    keys = _expand_keys([u32(c) for c in cw], ell, k)
    dead = (cnt <= 0).repeat_interleave(LMAX)
    keys = tuple(i32(x.masked_fill(dead, M32)) for x in keys)
    counts = cnt.repeat_interleave(LMAX) * (1 - _is_sentinel_i32(keys))
    return keys + (counts,)


def expand_chunk(run_cols, k: int, bloom=None, hfn: int = 0, kernels: str = "cuda"):
    """(Wc content cols, meta col, count col) -> W int32 key columns +
    int32 count column over R * LMAX rows, unsorted: E1 (``cuda_expand.
    expand_runs``: the kernel on CUDA tensors, its plain version on CPU
    ones) under ``kernels="cuda"``, the plain version ``expand_runs_plain``
    under "plain".  Dead run rows (count 0) and slots past ell become
    sentinel keys with count 0, and so do keys that miss the Bloom filter
    ``bloom`` (int32 words, ``hfn`` bits per key) when one is given: a run
    row packs up to LMAX windows, so the two-pass mode's per-window gate
    (``sortcount.bloom_gate``) applies here, where windows materialize.
    Runs in the span ``expand``, the finalize's expansion."""
    check_kernels(kernels)
    with trace.span("expand"):
        if kernels == "cuda":
            from . import cuda_expand

            rows = cuda_expand.expand_runs(run_cols, k)
        else:
            rows = expand_runs_plain(run_cols, k)
        if bloom is None:
            return rows
        keys = bloom_gate(bloom, rows[:-1], hfn, kernels)
        counts = rows[-1]
        counts.mul_(1 - _is_sentinel_i32(keys))    # in place: on the card, E1's count row
        return keys + (counts,)


def _expand_compact(run_cols, k: int, kernels: str, bloom=None, hfn: int = 0):
    """Single-shot finalize: expand every run row and sum equal keys."""
    return compact_clamped(expand_chunk(run_cols, k, bloom, hfn, kernels), kernels)


def _expand_merge_at(acc, run_cols, start: int, *, k: int, chunk: int, kernels: str,
                     bloom=None, hfn: int = 0):
    """Chunked finalize step: expand ``chunk`` run rows from ``start``
    and merge them into the accumulator (cut to its capacity)."""
    part = tuple(c[start: start + chunk] for c in run_cols)
    rows = expand_chunk(part, k, bloom, hfn, kernels)
    cap = acc[0].shape[0]
    store, ndv = compact_clamped(tuple(torch.cat([a, r]) for a, r in zip(acc, rows)),
                                 kernels)
    return tuple(c[:cap] for c in store), ndv


def finalize_store(run_store, k: int, chunk_rows: int = 1 << 20,
                   single_shot_rows: "int | None" = None, kernels: str = "cuda",
                   bloom=None, hfn: int = 0):
    """Expand the distinct run store (Wc content + meta + count columns,
    int32 tensors) into a sorted k-mer store ON the store's device,
    dropping keys that miss the Bloom filter ``bloom`` when one is given.
    Returns (W key columns + count column, n_used); rows past n_used
    are sentinels with count 0.

    Stores whose expansion fits ``single_shot_rows`` take one expand +
    compact; larger ones merge ``chunk_rows`` runs at a time into an
    accumulator that doubles when a merge overflows it."""
    W = words_per_kmer(k)
    R = int(run_store[0].shape[0])
    dev = run_store[0].device
    if R == 0:
        return make_store(0, W, dev), 0
    if single_shot_rows is None:
        # one expand + compact holds ~3 sort generations of W+1 words
        single_shot_rows = min(1 << 26, (6 << 30) // ((W + 1) * 12))
    if R * LMAX <= single_shot_rows:
        store, ndv = _expand_compact(run_store, k, kernels, bloom, hfn)
        trace.count("finalize_chunks")
        trace.count("host_syncs")
        return store, int(ndv[1])

    pad = (-R) % chunk_rows
    # the padded columns as rows of one buffer, which E1 reads where they lie
    buf = torch.empty((len(run_store), R + pad), dtype=torch.int32, device=dev)
    buf[:-1, R:] = -1
    buf[-1, R:] = 0
    for row, c in zip(buf, run_store):
        row[:R] = c
    run_cols = tuple(buf.unbind(0))
    cap = next_store_size(4 * chunk_rows, coarse=True)
    acc = make_store(cap, W, dev)
    nd = 0
    for s0 in range(0, R, chunk_rows):
        while True:
            new_acc, ndv = _expand_merge_at(acc, run_cols, s0, k=k, chunk=chunk_rows,
                                            kernels=kernels, bloom=bloom, hfn=hfn)
            trace.count("finalize_chunks")
            trace.count("host_syncs")
            nd = int(ndv[1])
            if nd <= acc[0].shape[0]:
                acc = new_acc
                break
            trace.count("finalize_regrows")
            cap = next_store_size(max(nd, 2 * acc[0].shape[0]), coarse=True)
            acc = tuple(torch.cat([c, dead_fill(cap - c.shape[0], i == W, dev)])
                        for i, c in enumerate(acc))
    return acc, nd

