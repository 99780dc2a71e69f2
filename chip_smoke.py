#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root.  It builds the port's CUDA kernels from
``kaarme_tpu_torch/csrc`` (into ``build/``), then:

1. K1 (dense run segmentation) at the skm path's shape (k=51, 2^26
   windows of 150 bp reads with separators and N patches), from the
   transfer chunk (2-bit words plus the separator bitmap): kernel ==
   plain PyTorch version (the unpack, then the plain segmentation), and
   an overflow case that must leave a guard region past ``cap``
   untouched; its time beside the plain version's and its bound;
2. K2 (segment-sum + compaction) in embedded mode at the run-store
   merge's shape (6 columns) and in full_sum mode at the finalize's
   shape (4 key columns + count): kernel == plain; and bit for bit on
   its edge cases: one key over more than 64 of its tiles in both modes
   (its full_sum mass crossing 2^20), W = 1 and W = 15, N = 0, and
   out_len < nd with a guard region past out_len left untouched;
3. K3 (canonical window keys) from the transfer chunk at the classic
   path's shape (k=51 and k=13, 2^26 windows) and at k=201 on a small
   and an odd tail length: kernel == plain (the unpack, then the plain
   window keys), bit for bit; its time beside the plain version's and
   the unpack's alone;
4. K4 (linear merge fused with the compaction) at the classic merge's
   shape: the dense store after one 2^26-window superstep, padded to
   2^23 rows, merged with the next 2^26 sorted window keys, embedded
   (k=51) and separate-count (k=13), plus an overflow case with a guard
   region; one key over more than 64 of its tiles whose total crosses
   2^20 (W = 4, 1 and 13), with a guard past out_len < nd; and K2's
   full_sum mode at the classic k=13 superstep's shape;
5. K5 (slotted run segmentation) from K1's transfer chunk at the
   slotted skm path's shape (k=51, 2^26 windows, S=96) and with S=16,
   where tiles overflow and the same rows must be dropped: kernel ==
   plain (the unpack, then the plain segmentation), rows and
   max_tile_runs; and on a tail of no whole number of 512-window tiles;
6. T1 (the atomic probe-table insert from K3's key columns: validity
   and the murmur3 hash in the kernel, equal keys of a warp aggregated)
   against its plain version (torch validity and ``hash_words``, then
   the probe rounds): one 2^20-window batch of the table route into a
   2^23-slot table already holding the previous batches' keys at k=51
   (W=4), k=13 (W=1) and k=201 (W=13), a poly-A batch and an AC-repeat
   batch, as multisets of occupied (key row, count) pairs with the
   table's invariants (no key in two slots, lookup along the
   ``hash_words`` chain finds every stored key, so the kernel's hash is
   ``hash_words``); overfull 2^8-slot tables (max_probes=8) where stored
   + pending == input per key; its time beside the plain version's, K3's
   alone and its bound;
7. the CLI end to end on small inputs (skm: k=31 and k=51, -m 0 and
   -m 2; classic: k=13, and k=31 with ``--compactor merge``) against a
   string-based golden count, and the slotted skm counter at S=8
   (S-ladder replays) against it too;
8. the CLI at full size: a random 4.6 Mb genome, 150 bp reads at 30x
   coverage, ``-s 8000000 -a 1``: k=51 on the skm route (count file ==
   ``--kernels plain``), the slotted skm counter (``segpack="slotted"``,
   the library API; count file == the skm route's, K5 launched on every
   superstep), k=51 on the classic route with and without
   ``--compactor merge`` (count files == the skm route's), and k=13 on
   the classic route (counts sum to the valid windows; count file ==
   ``--kernels plain`` == ``--compactor merge``); then the two-pass
   Bloom prefilter ``-b -u 5000000 -a 2`` at k=51 on the skm route and
   the classic route with and without the merge (count files == the
   ``-a 1`` file without its count-1 lines); each with the launch
   counters of its kernels > 0 (K3 exactly once per dispatched classic
   superstep and Bloom pass-1 superstep, K4 once per merge superstep,
   B1 once per pass-1 superstep, B2 once per classic pass-2 superstep
   and at least once in the skm finalize, E1 once per skm finalize chunk
   attempt and never under ``--kernels plain``) and its peak device memory
   printed, and no call of ``hash_words``, ``torch.unique`` or
   ``bloom.set_bits`` (the torch chain B1 and B2 replace); then the
   probe table (``--backend table``, written in slot order, so compared
   sorted by ``utils/compare.py``): k=51 (== the skm route's file), the
   same with ``--kernels plain`` (== the kernel run; T1 never launched),
   k=13 (== the classic k=13 file, counts summing to the valid windows)
   and ``-b -u 5000000 -a 2`` (== the skm route's ``-b`` file), T1
   launched once per batch (and twice per grow event), K3 once per batch
   (and per Bloom pass-1 batch and grow event), B1 and B2 once per batch
   of the ``-b`` run, and no ``hash_words``, ``torch.unique`` or
   ``set_bits`` call on any kernel run;
9. the sharded counters (``kaarme_tpu_torch/parallel``, ``--devices``)
   on the same full-size file through the library, sized as the CLI
   sizes ``--devices N -s 8000000 -a 1``, with N shards on cuda:0 (the
   real routing, record exchange and kernels on every shard): k=51 skm
   on 2 and on 4 shards and k=51 classic ``--compactor merge`` on 2 (==
   the skm route's file), k=13 classic on 4 (== the classic k=13 file,
   counts summing to the valid windows), the k=51 probe table on 2 (==
   the skm route's file once sorted); each with its count, exchange,
   write and wall times, peak device memory, rounds, replays, grow
   events and distinct records per shard, and its launch counters (K5,
   or K3 and K4, once per shard step; T1 per shard per batch and grow);
   a checkpoint saved mid-stream on 4 shards and resumed on 2 (== the
   uninterrupted run), and the CLI's ``--devices 2`` on a one-card
   machine exiting 1 with "need 2 devices";
10. multi-host counting (``kaarme_tpu_torch/parallel/multihost.py``) on
   the same file, each run real processes (``subprocess``, each with a
   timeout) that call the launcher (``multihost.run``, the body of its
   ``main``) with jax and kaarme_tpu refused by the import system:
   k=51 on two processes sharing cuda:0 over gloo (records staged
   through pinned host memory; merged file == the skm route's, the
   parts disjoint and summing to the distinct count, both processes on
   one prefix cap and one count of grow events), k=51 at world size 1
   on NCCL (== the skm route's), k=13 on two gloo processes (== the
   classic k=13 file, counts summing to the valid windows), a
   checkpoint saved by both processes halfway through their spans and
   resumed (== the first run), and ``--num-processes 3`` exiting 1
   before it connects; per process its start, count, exchange, write
   and merge times, peak device memory, rounds, replays, grow events,
   staged exchange bytes and launch counters (K3 once per shard step,
   K2 once more for the exchange's compaction, K4 never, W1 for the
   part file);
11. W1 (the count file's lines, ``kaarme_tpu_torch/ops/writer.py``)
   against its plain version, byte for byte with the line count, on
   random sorted rows at full size: 4,599,948 rows at k=51 (a sort
   store's column layout, -a 1), 4,297,645 rows at k=13 scattered over
   a 2^23-slot table's (C, W) slot rows (empty slots write nothing),
   2^20 rows at k=201 (-a 2), and k=51 with -m 0 -a 0 and counts up to
   70,000 (wrapped counts of 0 written, dead rows not); each with its
   kernel and plain times, its byte bound and the copy of its text into
   pinned host memory; then 2^26 rows at k=51 (about 3.7 GB of text,
   more than 2^31 bytes) through ``write_lines``' row chunks, every
   chunk equal to the plain version's (and by digest), with each
   chunk's kernel and device-to-host milliseconds.  Every count file
   of items 7-10 is written by W1 (its launch counter > 0 on every
   kernel run, 0 under ``--kernels plain``), so their comparisons hold
   it end to end;
12. B1 and B2 (``kaarme_tpu_torch/ops/cuda_bloom.py``: the ``-b`` pass-1
   insert and pass-2 gate) against their plain versions (the torch
   hash, ``torch.unique`` and bit planes of ``ops/bloom.py``; the torch
   gate) at the full phase's filter size (``-u 5000000``: 2^28 bits a
   stage, 7 hash functions): the table's pass-1 loop over 63 batches of
   2^20 k=51 windows, each step (K3 + B1) under
   ``torch.cuda.set_sync_debug_mode("error")`` (it makes no host
   synchronisation) beside the plain route's step, BF1, BF2 and the
   summed counters equal; then the next batch and two 2^26-window sort
   supersteps (the first on empty filters, the second after it): B1 ==
   plain on both stages' words and both counters, B2 == plain on the
   key words, each timed from fresh copies with its bound and share (the
   4W key bytes, each distinct 32 B filter sector the valid keys' words
   lie in read once and each changed one written once; B2 the words of
   the keys it gates); their ``ms`` is CUDA events around the call, as
   for every other kernel, and ``dev_ms`` the card's time alone, their
   launches queued behind a sleep kernel (``cuda_ms_queued``: at a table
   batch the host's Python before and between the launches outlasts the
   kernels); B1's epoch wrap (nine table batches on one scratch, from
   epochs 1-3 on to EPOCH_MAX - 2 and across the wrap, == plain after
   each); and a 2^10-bit filter under heavy collision, poly-A (one root
   2^20 times), k=201 and k=13 on 777 windows, two batches each on one
   scratch;
13. E1 (``kaarme_tpu_torch/ops/cuda_expand.py``: the skm finalize's
   expansion of run rows into canonical keys) against its plain version
   (``skm.expand_runs_plain``), bit for bit on every key and count
   column, at the finalize's chunk (2^20 runs, k=51: 16.8 M rows), at
   k=201 (W = 13), and on tails of no whole block at k=300 (W = 19) and
   k=16; the 2^20-run cases timed beside the plain chain and the bound,
   one launch a call;
14. P1 (``kaarme_tpu_torch/ops/cuda_parse.py``: FASTA and plain text
   parsed and packed on the card) through the device code stream
   (``io/rawstream.py``) on a 147 MB FASTA of 150 bp reads in 8 MiB
   blocks at the full-size superstep (2^26 windows, k=51): every chunk
   == the host's ``encode_fasta`` + ``pack_stream`` of the same codes;
   the same FASTA with CRLF line ends and wrapped lines in 4 KiB blocks
   == the plain version; one 8 MiB block timed (the call, and the
   card's time queued behind a sleep kernel) beside the plain version
   and the host's encode + pack, with its bound (the raw bytes read once,
   the words and bitmap written once).

Each kernel phase also computes the kernel's bound at its shape: the
least time the card could take, each input byte read once and each
output byte written once at 3.35 TB/s against its 32-bit operations at
67 T/s (H100 SXM data sheet).  The full-size skm run checks that K1 was
launched once per superstep and replay.  Each phase raises on failure
(non-zero exit).  The last lines are the kernel table as JSON (with
each kernel's bound, its share and ``library_ms``: null, as no single
PyTorch call computes any of these functions; T1, which is not a TPU
kernel but replaces the JAX package's XLA probe rounds, W1, which
replaces its host numpy writer, and B1 and B2, which replace its XLA
Bloom filter ops, E1, which replaces its fused jnp expansion, and P1,
which replaces its host encode and pack, have their entries too), the card's
name and power limit, and {"ok": true, "device": {...}}.  Exits
non-zero without a CUDA device, and where the port has imported jax or
kaarme_tpu.
"""

from __future__ import annotations

import contextlib
import filecmp
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

K = 51
N_WINDOWS = 1 << 26        # the superstep the CLI picks for the full-size file
DISTINCT_K51 = 4_599_948   # distinct 51-mers of the full-size file (both pipelines)
SEED = 20261016


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` by CUDA events (one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over paired int32 tensors, compared as
    the uint32 patterns they hold."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = ((a.to("cpu").long() & 0xFFFFFFFF) - (b.to("cpu").long() & 0xFFFFFFFF)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def read_stream(dev, genome_len: int, n_pos: int, read_len: int = 150, n_every=None):
    """int32 codes of reads sampled from a random genome, one separator
    (code 4) after each read, plus N patches (code 4) every ``n_every``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    genome = torch.randint(0, 4, (genome_len,), generator=g, device=dev, dtype=torch.int32)
    n_reads = -(-n_pos // (read_len + 1))
    starts = torch.randint(0, genome_len - read_len, (n_reads, 1), generator=g, device=dev)
    reads = genome[starts + torch.arange(read_len, device=dev)]
    codes = torch.cat([reads, torch.full((n_reads, 1), 4, dtype=torch.int32, device=dev)], 1)
    codes = codes.reshape(-1)[:n_pos].contiguous()
    if n_every:
        for off in range(3):
            codes[1000 + off::n_every] = 4
    return codes


def chunk_of(codes):
    """The transfer chunk of int32 codes (>= 4: invalid) as the host ships
    it (``fastio.pack_stream`` and ``SortKmerCounter._prepare``): 2-bit
    bases, base i at bits 2*(i%16) of word i/16, invalid positions as
    base 0; the separator bitmap, bit i%32 of word i/32.  Both int32
    tensors holding u32 bit patterns."""
    import torch

    L = codes.shape[0]
    bad = codes >= 4
    bases = torch.where(bad, 0, codes & 3).long()
    bases = torch.cat([bases, bases.new_zeros((-L) % 16)]).view(-1, 16)
    packed = (bases << (2 * torch.arange(16, device=codes.device))).sum(1).to(torch.int32)
    bits = torch.cat([bad.long(), bad.new_zeros((-L) % 32).long()]).view(-1, 32)
    mask = (bits << torch.arange(32, device=codes.device)).sum(1).to(torch.int32)
    return packed, mask


# H100 SXM peaks (NVIDIA's data sheet; the card's power limit is printed
# beside them): HBM bytes/s, and the 32-bit vector rate (67 TFLOP/s
# float32 outside the tensor cores) taken for the kernels' 32-bit integer
# operations, whose own rate is no higher.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound(inputs, outputs, ops: float) -> dict:
    """The least time the card could take: each input byte read once,
    each output byte written once, over the HBM rate, against ``ops``
    32-bit operations over the vector rate; the larger sets the bound."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", bound_bytes=nbytes, bound_ops=ops)


def timed(d: dict) -> dict:
    """The kernel entry of the JSON line: its bound share (bound over
    kernel time) and no library call (none computes these functions)."""
    return dict(d, bound_share=d["bound_ms"] / d["ms"], library_ms=None)


def phase_k1(dev):
    """K1 from the transfer chunk at the skm path's shape against its
    plain version (the unpack, then the plain segmentation), with an
    overflow guard; its time beside the plain version's and its bound."""
    import torch
    from kaarme_tpu_torch.ops import cuda_skm, sortcount

    L = N_WINDOWS + K - 1
    packed, mask = chunk_of(read_stream(dev, 4_600_000, L, n_every=100_003))
    cap = sortcount.next_store_size(N_WINDOWS // 8)     # the counter's first capacity
    Wc = cuda_skm.content_words(K)
    got = cuda_skm.run_rows_dense(packed, mask, k=K, n=N_WINDOWS, cap=cap)
    want = cuda_skm.run_rows_dense_plain(packed, mask, k=K, n=N_WINDOWS, cap=cap)
    torch.cuda.synchronize()
    rows = want[1].tolist()
    if got[1].tolist() != rows or rows[0] > cap:
        raise AssertionError(f"K1 rows {got[1].tolist()} vs plain {rows} (cap {cap})")
    err = max_abs_err(got[0], want[0])
    if err:
        raise AssertionError(f"K1 kernel != plain (max abs err {err})")
    # overflow: a capacity below the live rows; nothing may land past it
    small, guard = rows[0] // 3, 4096
    out = torch.full((Wc + 1, small + guard), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    ocols, orows = cuda_skm.launch_dense(packed, mask, K, N_WINDOWS, out, small)
    torch.cuda.synchronize()
    if orows.tolist() != rows:
        raise AssertionError(f"K1 overflow rows {orows.tolist()} != {rows}")
    if not bool((out[:, small:] == 0x5A5A5A5A).all()):
        raise AssertionError("K1 wrote past cap")
    err = max(err, max_abs_err(ocols, [c[:small] for c in want[0]]))
    if err:
        raise AssertionError("K1 overflow prefix != plain")
    del want, out, ocols
    ms = cuda_ms(lambda: cuda_skm.run_rows_dense(packed, mask, k=K, n=N_WINDOWS, cap=cap))
    plain_ms = cuda_ms(lambda: cuda_skm.run_rows_dense_plain(packed, mask, k=K, n=N_WINDOWS,
                                                             cap=cap))
    # the chunk in, every row of the Wc+1 columns and [rows] out; ~20
    # operations per window (m-word, validity, sliding minimum, starts)
    b = bound([packed, mask], list(got[0]) + [got[1]], 20.0 * N_WINDOWS)
    print(f"K1 skm_dense k={K} n={N_WINDOWS} cap={cap} rows={rows[0]} from the chunk "
          f"({packed.numel()} packed words, {mask.numel()} bitmap words): == plain, overflow "
          f"cap={small}: guard intact; kernel {ms:.3f} ms; codes_from_chunk + plain "
          f"{plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
          f"{b['bound_bytes']} bytes, {b['bound_ops']:.0f} operations)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b), got


def k2_merge_input(cols, r: int):
    """K2's merge shape from K1's first ``r`` rows of a superstep: the
    distinct store after it (the prefix) merged with the same rows
    again, as superstep 2 does, sorted.  Returns (the (w, N) rows, the
    prefix's distinct count)."""
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, skm, sortcount

    w = skm.store_words(K)
    rows_cols = tuple(c[:r] for c in cols)
    s1 = sortcount.lexsort(list(rows_cols), num_keys=w)
    ok, oc, nd1 = cuda_compact.segsum_compact_torch(s1, None, ebits=skm.EBITS)
    n1 = int(nd1[0])
    prefix = [c[:n1] for c in ok] + [oc[:n1]]
    merge = [torch.cat([prefix[i], rows_cols[i]]) for i in range(w - 1)]
    merge.append(torch.cat([prefix[w - 1] | prefix[-1], rows_cols[w - 1]]))
    return sortcount.lexsort(merge, num_keys=w), n1


def k2_finalize_input(store, n1: int):
    """K2's finalize shape: the merged store's n1 distinct runs (count 2
    each now) expanded to k-mers and sorted.  Returns (keys, cnt)."""
    from kaarme_tpu_torch.ops import skm, sortcount

    runs = [c[:n1] for c in store[0]] + [store[1][:n1]]
    ex = skm.expand_chunk(tuple(runs), K)
    fs = sortcount.lexsort(list(ex[:-1]) + [ex[-1]], num_keys=len(ex) - 1)
    return fs[:-1], fs[-1].contiguous()


def k2_classic_input(pk, pc, nxt0):
    """K2's classic k=13 (separate-count) superstep shape: the store
    prefix (keys pk, counts pc) and the next batch's window keys nxt0
    with unit counts, sorted.  Returns (keys (1, N), cnt)."""
    import torch
    from kaarme_tpu_torch.ops import sortcount

    cnt = torch.cat([pc, torch.ones(nxt0.shape[0], dtype=torch.int32, device=pc.device)])
    s = sortcount.lexsort([torch.cat([pk[0], nxt0]), cnt], num_keys=1)
    return s[:1], s[1].contiguous()


def k4_runs(first, nxt, k: int, compact, cap: int):
    """K4's inputs at the classic merge superstep: the store after one
    superstep (the window keys ``first`` sorted and compacted by
    ``compact``, K2 or its plain version, dense in ``cap`` rows) and the
    next superstep's window keys ``nxt``, sorted.  Returns (a, b,
    embedded, ebits, (pk, pc, nd1)): the store's keys and counts as
    ``compact`` gave them."""
    import torch
    from kaarme_tpu_torch.ops import sortcount

    eb = sortcount.embed_bits(k)
    emb = eb >= 21
    W = len(first)
    if emb:
        s1 = sortcount.lexsort(list(first[:-1]) + [first[-1] | 1], num_keys=W)
        pk, pc, nd1 = compact(s1, None, ebits=eb, out_len=cap)
        a = torch.cat([pk[:-1], (pk[-1] | pc)[None]])
        b = sortcount.lexsort(list(nxt[:-1]) + [nxt[-1] | 1], num_keys=W)
    else:
        ones = torch.ones(first[0].shape[0], dtype=torch.int32, device=first[0].device)
        s1 = sortcount.lexsort(list(first) + [ones], num_keys=W)
        pk, pc, nd1 = compact(s1[:W], s1[W].contiguous(), out_len=cap)
        a = torch.cat([pk, pc[None]])
        b = sortcount.lexsort(list(nxt), num_keys=W)
    return a, b, emb, eb if emb else 0, (pk, pc, nd1)


def phase_k2(dev, k1_out):
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, skm

    (cols, rows) = k1_out
    w = skm.store_words(K)
    s, n1 = k2_merge_input(cols, int(rows[0]))
    got = cuda_compact.segsum_compact(s, None, ebits=skm.EBITS)
    want = cuda_compact.segsum_compact_torch(s, None, ebits=skm.EBITS)
    torch.cuda.synchronize()
    if got[2].tolist() != want[2].tolist() or want[2].tolist()[0] != n1:
        raise AssertionError(f"K2 embedded nd {got[2].tolist()} vs {want[2].tolist()}, {n1}")
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"K2 embedded kernel != plain (max abs err {err})")
    ms = cuda_ms(lambda: cuda_compact.segsum_compact(s, None, ebits=skm.EBITS))
    plain_ms = cuda_ms(lambda: cuda_compact.segsum_compact_torch(s, None, ebits=skm.EBITS))
    # per row: compare with the successor's w words, one segmented add
    b = bound([s], got, (w + 4.0) * s.shape[1])
    print(f"K2 segsum_compact embedded ebits=26: {w} cols x {s.shape[1]} rows, "
          f"nd={n1}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")

    keys, cnt = k2_finalize_input(got, n1)
    fgot = cuda_compact.segsum_compact(keys, cnt)
    fwant = cuda_compact.segsum_compact_torch(keys, cnt)
    torch.cuda.synchronize()
    ferr = max_abs_err(fgot, fwant)
    if ferr or fgot[2].tolist() != fwant[2].tolist():
        raise AssertionError(f"K2 full_sum kernel != plain (max abs err {ferr})")
    fms = cuda_ms(lambda: cuda_compact.segsum_compact(keys, cnt))
    fplain = cuda_ms(lambda: cuda_compact.segsum_compact_torch(keys, cnt))
    fb = bound([keys, cnt], fgot, (keys.shape[0] + 4.0) * keys.shape[1])
    print(f"K2 segsum_compact full_sum: {keys.shape[0]}+1 cols x {keys.shape[1]} rows, "
          f"nd={int(fwant[2][0])}; kernel {fms:.3f} ms, plain {fplain:.3f} ms, bound "
          f"{fb['bound_ms']:.4f} ms ({fb['bound_by']})")
    err = max(err, ferr, k2_cases(dev))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                full_sum_ms=fms, full_sum_plain_ms=fplain, full_sum_bound_ms=fb["bound_ms"], **b)


def k2_rows(dev, g, W: int, N: int, embedded: bool, long_seg: bool):
    """Sorted K2 input: W key columns over 40 values (every 9th row a
    sentinel), or with ``long_seg`` one key over rows 100 .. N-300 and
    sentinels in the last 50 rows; embedded: counts in [1, 2^21) in the
    last word's low 26 bits; full_sum: a count column, near 2^20 on the
    long key.  Returns (keys, cnt or None)."""
    import torch
    from kaarme_tpu_torch.ops import sortcount

    keys = torch.randint(0, 40, (W, N), generator=g, device=dev, dtype=torch.int64)
    keys[0] |= 0x80000000
    sent = torch.zeros(N, dtype=torch.bool, device=dev)
    if long_seg:
        keys[:, 100:N - 300] = keys[:, 100:101]
        sent[N - 50:] = True
    else:
        sent[::9] = True
    if embedded:
        keys[-1] = ((keys[-1] << 26) & 0xFFFFFFFF) | torch.randint(
            1, 1 << 21, (N,), generator=g, device=dev)
    keys[:, sent] = 0xFFFFFFFF
    cols = [k.to(torch.int32) for k in keys]   # uint32 patterns as int32 (wraps)
    if not embedded:
        lo = (1 << 20) - 3 if long_seg else 0
        cols.append(torch.randint(lo, 1 << 20, (N,), generator=g, device=dev,
                                  dtype=torch.int32).masked_fill(sent, 0))
    s = sortcount.lexsort(cols, num_keys=W)
    return (s, None) if embedded else (s[:W].contiguous(), s[W].contiguous())


def k2_cases(dev) -> int:
    """K2's edge cases against the plain version, bit for bit: one key
    over more than 64 tiles of 2048 rows in both modes (its carry comes
    from the look-back, over more than one round of 32 tiles; the
    full_sum mass crosses 2^20 again and again, the embedded total
    crosses it once), W = 1 and W = 15, N = 0, and out_len < nd into a
    buffer whose guard region past out_len must stay untouched."""
    import torch
    from kaarme_tpu_torch.ops import cuda_compact

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    n_long = 66 * 2048 + 777
    done = []
    for W, N, emb, long_seg in ((2, n_long, True, True), (1, n_long, False, True),
                                (1, 300_001, True, False), (15, 200_003, True, False),
                                (15, 70_001, False, False), (3, 0, True, False),
                                (1, 0, False, False)):
        keys, cnt = k2_rows(dev, g, W, N, emb, long_seg)
        eb = 26 if emb else 0
        want = cuda_compact.segsum_compact_torch(keys, cnt, ebits=eb)
        got = cuda_compact.segsum_compact(keys, cnt, ebits=eb)
        torch.cuda.synchronize()
        nd = want[2].tolist()
        e = max_abs_err(got, want)
        if e or got[2].tolist() != nd:
            raise AssertionError(f"K2 W={W} N={N} embedded={emb}: kernel != plain (max abs err "
                                 f"{e}, nd {got[2].tolist()} vs {nd})")
        if long_seg:
            top = int(want[1].max())
            if not (1 << 20) < top < (1 << 21) or nd[0] < 3:
                raise AssertionError(f"K2 long key: total {top}, nd {nd}")
            small, guard = nd[0] // 2, 4096
            buf = torch.full((W + 1, small + guard), 0x5A5A5A5A, dtype=torch.int32, device=dev)
            ok, oc, ond = cuda_compact.launch_compact(keys, cnt, buf, small, ebits=eb)
            torch.cuda.synchronize()
            if ond.tolist() != nd or not bool((buf[:, small:] == 0x5A5A5A5A).all()):
                raise AssertionError(f"K2 out_len {small} < nd {nd}: wrote past out_len")
            if max_abs_err([ok, oc], [want[0][:, :small], want[1][:small]]):
                raise AssertionError("K2 overflow prefix != plain")
        done.append(f"W={W} N={N} {'embedded' if emb else 'full_sum'}"
                    + (f" (one key over {(N - 400) // 2048} tiles, out_len {nd[0] // 2} < nd "
                       f"{nd[0]}: guard intact)" if long_seg else f" nd={nd[0]}"))
    print(f"K2 edge cases == plain: {'; '.join(done)}")
    return 0


def phase_k3(dev):
    """K3 from the transfer chunk at the classic path's shape (k=51 and
    k=13 over 2^26 windows; and the next 2^26 windows for phase_k4) and
    at k=201 (small n and a tail n that is no multiple of the tile),
    against its plain version (the unpack, then the plain window keys),
    bit for bit; its time beside the plain version's, the unpack's
    alone, and its bound on the chunk's bytes."""
    import torch
    from kaarme_tpu_torch.ops import cuda_winkeys, sortcount

    err, times, batches = 0, {}, {}
    for k in (51, 13):
        codes = read_stream(dev, 4_600_000, 2 * N_WINDOWS + k - 1, n_every=100_003)
        packed, mask = chunk_of(codes[:N_WINDOWS + k - 1])
        got = cuda_winkeys.window_keys(packed, mask, k=k, n=N_WINDOWS)
        want = cuda_winkeys.window_keys_plain(packed, mask, k=k, n=N_WINDOWS)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"K3 k={k} kernel != plain (max abs err {e})")
        err = max(err, e)
        del want
        ms = cuda_ms(lambda: cuda_winkeys.window_keys(packed, mask, k=k, n=N_WINDOWS))
        plain_ms = cuda_ms(lambda: cuda_winkeys.window_keys_plain(packed, mask, k=k, n=N_WINDOWS))
        unpack_ms = cuda_ms(lambda: sortcount.codes_from_chunk(packed, mask, k=k, n=N_WINDOWS))
        # the chunk in, the W key columns out; per window and key word ~12
        # operations (two funnel shifts, the field reversal, the compare
        # and select), plus the two bitmap ranks
        b = bound([packed, mask], got, (12.0 * len(got) + 8.0) * N_WINDOWS)
        times[k] = (ms, plain_ms, b, unpack_ms)
        nxt = chunk_of(codes[N_WINDOWS:])
        batches[k] = (got, cuda_winkeys.window_keys(nxt[0], nxt[1], k=k, n=N_WINDOWS))
        print(f"K3 window_keys k={k} n={N_WINDOWS} from the chunk ({packed.numel()} packed "
              f"words, {mask.numel()} bitmap words): == plain; kernel {ms:.3f} ms; "
              f"codes_from_chunk + plain {plain_ms:.3f} ms (the unpack alone {unpack_ms:.3f} "
              f"ms); bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bound_bytes']} bytes, "
              f"{b['bound_ops']:.0f} operations)")
        del codes, packed, mask, nxt
    for n in (1 << 16, 100_003):
        packed, mask = chunk_of(read_stream(dev, 4_600_000, n + 200, n_every=9_973))
        e = max_abs_err(cuda_winkeys.window_keys(packed, mask, k=201, n=n),
                        cuda_winkeys.window_keys_plain(packed, mask, k=201, n=n))
        if e:
            raise AssertionError(f"K3 k=201 n={n} kernel != plain (max abs err {e})")
        print(f"K3 window_keys k=201 n={n}: kernel == plain")
    ms, plain_ms, b, unpack_ms = times[51]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, unpack_ms=unpack_ms,
                k13_ms=times[13][0], k13_plain_ms=times[13][1],
                k13_bound_ms=times[13][2]["bound_ms"], **b), batches


def hot_runs(dev, W: int, embedded: bool, n_hot: int, seed: int):
    """Sorted K4 runs with one hot key: one A row of count 2^20 - 7 and
    n_hot B rows, among 300 other A keys and 900 other B rows, sentinel
    rows after both runs.  Returns (a, b, ebits)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    eb = 26 if embedded else 0
    low = 0xFFFFFFFF ^ ((1 << eb) - 1)

    def keys(m):
        x = rng.integers(0, 1 << 20, (m, W)).astype(np.int64)
        x[:, 0] |= 0x80000000
        x[:, -1] = (x[:, -1] << eb) & low
        return x

    key = keys(1)
    a = np.unique(np.concatenate([keys(300), key]), axis=0)
    acnt = rng.integers(1, 100, a.shape[0])
    acnt[(a == key).all(1)] = (1 << 20) - 7
    b = np.concatenate([keys(900), np.repeat(key, n_hot, 0)])
    b = b[np.lexsort(b.T[::-1])]
    if embedded:
        a[:, -1] |= acnt
        b[:, -1] |= 1
    a = np.concatenate([a, np.full((33, W), 0xFFFFFFFF)])
    b = np.concatenate([b, np.full((21, W), 0xFFFFFFFF)])
    cols = [a[:, w] for w in range(W)]
    if not embedded:
        cols.append(np.concatenate([acnt, np.zeros(33, np.int64)]))
    to = lambda c: torch.from_numpy(np.stack(c).astype(np.uint32).view(np.int32)).to(dev)
    return to(cols), to([b[:, w] for w in range(W)]), eb


def k4_hot_cases(dev):
    """K4 against its plain version with one key over more than 64 tiles
    at every tile size (66 x 4096 + 77 batch rows: its carry comes from the
    look-back only), its total crossing the 2^20 clamp, at W = 4
    embedded, W = 1 separate count and W = 13 embedded; then out_len < nd
    into a buffer whose guard past out_len must stay untouched."""
    import torch
    from kaarme_tpu_torch.ops import cuda_merge

    done = []
    for W, emb in ((4, True), (1, False), (13, True)):
        a, b, eb = hot_runs(dev, W, emb, 66 * 4096 + 77, seed=SEED + W)
        want = cuda_merge.merge_compact_torch(a, b, embedded=emb, ebits=eb)
        got = cuda_merge.merge_compact(a, b, embedded=emb, ebits=eb)
        torch.cuda.synchronize()
        nd = want[2].tolist()
        e = max_abs_err(got, want)
        top = int(want[1].max())
        if e or got[2].tolist() != nd or not (1 << 20) < top < (1 << 21):
            raise AssertionError(f"K4 hot key W={W} embedded={emb}: kernel != plain (max abs err "
                                 f"{e}, nd {got[2].tolist()} vs {nd}, top count {top})")
        small = nd[0] // 2
        buf = torch.full((W + 1, small + 4096), 0x5A5A5A5A, dtype=torch.int32, device=dev)
        ok, oc, ond = cuda_merge.launch_merge(a, b, buf, small, embedded=emb, ebits=eb)
        torch.cuda.synchronize()
        if ond.tolist() != nd or not bool((buf[:, small:] == 0x5A5A5A5A).all()):
            raise AssertionError(f"K4 hot key W={W}: out_len {small} < nd {nd}: wrote past out_len")
        if max_abs_err([ok, oc], [want[0][:, :small], want[1][:small]]):
            raise AssertionError(f"K4 hot key W={W}: overflow prefix != plain")
        done.append(f"W={W} {'embedded' if emb else 'separate count'} nd={nd[0]} (hot total "
                    f"{top}; out_len {small} < nd: guard intact)")
    print(f"K4 hot key over {66 * 4096 + 77} batch rows == plain: {'; '.join(done)}")


def phase_k4(dev, batches):
    """K4 against its plain version at the classic merge's shape, and
    K2's full_sum mode at the classic k=13 (separate-count) superstep's
    shape."""
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, cuda_merge

    cap = 1 << 23                     # -s 8000000
    out, err = {}, 0
    for k in (51, 13):
        first, nxt = batches.pop(k)
        W = len(first)
        # the store after superstep 1 (sort + K2), dense in `cap` rows
        a, b, emb, eb, (pk, pc, nd1) = k4_runs(first, nxt, k, cuda_compact.segsum_compact, cap)
        del first
        got = cuda_merge.merge_compact(a, b, embedded=emb, ebits=eb, out_len=cap)
        want = cuda_merge.merge_compact_torch(a, b, embedded=emb, ebits=eb, out_len=cap)
        torch.cuda.synchronize()
        nd = want[2].tolist()
        e = max_abs_err(got, want)
        if e or got[2].tolist() != nd or not 0 < nd[0] <= cap:
            raise AssertionError(f"K4 k={k} kernel != plain (max abs err {e}, nd "
                                 f"{got[2].tolist()} vs {nd})")
        err = max(err, e)
        ms = cuda_ms(lambda: cuda_merge.merge_compact(a, b, embedded=emb, ebits=eb, out_len=cap))
        plain_ms = cuda_ms(lambda: cuda_merge.merge_compact_torch(a, b, embedded=emb, ebits=eb,
                                                                  out_len=cap))
        # per merged row: a merge-path comparison of W words, then K2's
        kb = bound([a, b], got, (2.0 * W + 4.0) * (a.shape[1] + b.shape[1]))
        out[k] = (ms, plain_ms, kb)
        print(f"K4 merge_compact k={k} {'embedded' if emb else 'separate count'}: "
              f"{a.shape[0]} x {cap} prefix rows (nd {int(nd1[0])}) + {W} x {N_WINDOWS} "
              f"batch rows -> nd {nd[0]}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{kb['bound_ms']:.4f} ms ({kb['bound_by']})")
        if emb:
            # overflow: a capacity below nd; nothing may land past it
            small, guard = nd[0] // 3, 4096
            buf = torch.full((W + 1, small + guard), 0x5A5A5A5A, dtype=torch.int32, device=dev)
            ok, oc, ond = cuda_merge.launch_merge(a, b, buf, small, embedded=True, ebits=eb)
            torch.cuda.synchronize()
            if ond.tolist() != nd or not bool((buf[:, small:] == 0x5A5A5A5A).all()):
                raise AssertionError(f"K4 overflow: nd {ond.tolist()} vs {nd}, or wrote past "
                                     "out_len")
            e = max_abs_err([ok, oc], [want[0][:, :small], want[1][:small]])
            if e:
                raise AssertionError("K4 overflow prefix != plain")
            print(f"K4 overflow out_len={small} < nd={nd[0]}: guard intact, prefix == plain")
            del buf, ok, oc
        else:
            # K2 full_sum at the classic separate-count superstep's shape
            keys, c = k2_classic_input(pk, pc, nxt[0])
            fgot = cuda_compact.segsum_compact(keys, c, out_len=cap)
            fwant = cuda_compact.segsum_compact_torch(keys, c, out_len=cap)
            torch.cuda.synchronize()
            e = max_abs_err(fgot, fwant)
            if e or fgot[2].tolist() != nd or fwant[2].tolist() != nd:
                raise AssertionError(f"K2 full_sum (classic) kernel != plain (err {e})")
            fms = cuda_ms(lambda: cuda_compact.segsum_compact(keys, c, out_len=cap))
            fplain = cuda_ms(lambda: cuda_compact.segsum_compact_torch(keys, c, out_len=cap))
            fb = bound([keys, c], fgot, (keys.shape[0] + 4.0) * keys.shape[1])
            out["k2"] = (fms, fplain, fb)
            print(f"K2 segsum_compact full_sum (classic k=13 superstep): 1+1 cols x "
                  f"{keys.shape[1]} rows, nd={fwant[2].tolist()[0]}; kernel {fms:.3f} ms, "
                  f"plain {fplain:.3f} ms, bound {fb['bound_ms']:.4f} ms ({fb['bound_by']})")
            del keys, c, fgot, fwant
        del a, b, got, want, pk, pc, nxt
        torch.cuda.empty_cache()
    k4_hot_cases(dev)
    k4 = dict(max_abs_err=err, ms=out[51][0], plain_ms=out[51][1],
              k13_ms=out[13][0], k13_plain_ms=out[13][1], k13_bound_ms=out[13][2]["bound_ms"],
              **out[51][2])
    return k4, dict(classic_full_sum_ms=out["k2"][0], classic_full_sum_plain_ms=out["k2"][1],
                    classic_full_sum_bound_ms=out["k2"][2]["bound_ms"])


def phase_k5(dev):
    """K5 from K1's transfer chunk against its plain version (the unpack,
    then the plain slotted segmentation) at the slotted skm path's shape
    (k=51, 2^26 windows, S=96), with S=16 (tiles overflow: the same rows
    dropped, the same max_tile_runs > S), and on a tail of no whole
    number of 512-window tiles; its time beside the plain version's and
    its bound."""
    import torch
    from kaarme_tpu_torch.ops import cuda_skm

    packed, mask = chunk_of(read_stream(dev, 4_600_000, N_WINDOWS + K - 1, n_every=100_003))
    err, ms, plain_ms, b = 0, None, None, None
    for n, S in ((N_WINDOWS, 96), (N_WINDOWS, 16), (N_WINDOWS // 3 + 77, 96)):
        got = cuda_skm.run_rows_slotted(packed, mask, k=K, n=n, S=S)
        want = cuda_skm.run_rows_slotted_plain(packed, mask, k=K, n=n, S=S)
        torch.cuda.synchronize()
        mr = int(want[1])
        e = max_abs_err(got[0], want[0])
        if e or int(got[1]) != mr or (S == 16 and mr <= S):
            raise AssertionError(f"K5 n={n} S={S}: kernel != plain (max abs err {e}, "
                                 f"max_tile_runs {int(got[1])} vs {mr})")
        err = max(err, e)
        del want
        rows = cuda_skm.slot_rows(n, S)
        what = f"{rows} slot rows, max_tile_runs {mr}" + (" > S: rows dropped" if mr > S else "")
        if n == N_WINDOWS and S == 96:
            ms = cuda_ms(lambda: cuda_skm.run_rows_slotted(packed, mask, k=K, n=n, S=S))
            plain_ms = cuda_ms(lambda: cuda_skm.run_rows_slotted_plain(packed, mask, k=K, n=n,
                                                                       S=S))
            # the chunk in, every slot row and max_tile_runs out; ~20
            # operations per window, as K1
            b = bound([packed, mask], list(got[0]) + [got[1]], 20.0 * n)
            what += (f"; kernel {ms:.3f} ms; codes_from_chunk + plain {plain_ms:.3f} ms; bound "
                     f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bound_bytes']} bytes, "
                     f"{b['bound_ops']:.0f} operations)")
        print(f"K5 skm_slotted k={K} n={n} S={S} from the chunk: {what}; kernel == plain")
        del got
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)


TABLE_TILE, TABLE_BATCH_TILES = 1 << 14, 64     # CounterConfig's defaults: 2^20 windows
TABLE_LOG2 = 23                                   # -s 8000000


def table_batch(codes, b: int, k: int):
    """Batch ``b`` of the table route over int32 codes (64 tiles of 2^14
    windows): its transfer chunk, and the route's step before T1 on it
    (K3's key columns, ``sortcount.window_keys_from_chunk``) as a
    function of no arguments returning the W columns."""
    from kaarme_tpu_torch.ops import sortcount

    per = TABLE_TILE * TABLE_BATCH_TILES
    packed, bitmap = chunk_of(codes[b * per: (b + 1) * per + k - 1])
    return lambda: sortcount.window_keys_from_chunk(packed, bitmap, k=k, n=per)


def occupied_rows(tk, cn):
    """The table's occupied (key row, count) pairs sorted by key: (W+1, m)."""
    from kaarme_tpu_torch.ops import sortcount

    occ = cn > 0
    return sortcount.lexsort(list(tk[occ].T) + [cn[occ]], num_keys=tk.shape[1])


def check_table(tk, cn, max_probes: int, what: str):
    """The table's invariants: no key in two slots, every stored key
    found by the probe-round lookup with its count; returns the sorted
    occupied rows."""
    import torch
    from kaarme_tpu_torch.ops import hashing, table

    rows = occupied_rows(tk, cn)
    W = tk.shape[1]
    if rows.shape[1] > 1 and not bool((rows[:W, 1:] != rows[:W, :-1]).any(0).all()):
        raise AssertionError(f"{what}: a key sits in two slots")
    keys = tuple(rows[:W])
    found = table.lookup(tk, cn, keys, hashing.hash_words(keys), max_probes=max_probes)
    if not torch.equal(found, rows[W]):
        raise AssertionError(f"{what}: lookup misses stored keys")
    occupancy = int((cn > 0).sum())
    if occupancy != rows.shape[1]:
        raise AssertionError(f"{what}: occupancy {occupancy} != {rows.shape[1]} distinct keys")
    return rows


def key_totals(keys, amounts):
    """(distinct key columns (W, d), the summed amount of each)."""
    import torch
    from kaarme_tpu_torch.ops import sortcount

    uk, inv = torch.unique(torch.stack([sortcount.i32(x) for x in keys]), dim=1,
                           return_inverse=True)
    tot = torch.zeros(uk.shape[1], dtype=torch.int64, device=uk.device)
    return uk, tot.index_add_(0, inv, amounts.to(torch.int64))


def table_traffic(cn0, tk, cn, keys, valid, h, max_probes: int) -> dict:
    """What an insert of this batch must move in the table, from its
    counts before (cn0) and the table after (tk, cn): the probe chains
    of the valid windows end at their key's slot (max_probes probes for
    one left pending); each distinct 32 B sector of counts and of key
    rows that the chains touch is read once, and each such sector whose
    content changed is written once, however many probes share it."""
    import torch
    from kaarme_tpu_torch.ops import cuda_table, sortcount

    C, W = tk.shape
    kmat = torch.stack([sortcount.i32(x) for x in keys], 1)
    hv = h.to(torch.int64) & 0xFFFFFFFF
    pending = valid.clone()
    probe = torch.zeros_like(hv)
    touched, probes = [], 0
    for _ in range(max_probes):
        probes += int(pending.sum())
        if not bool(pending.any()):
            break
        slot = (hv + cuda_table._tri(probe)) & (C - 1)
        touched.append(slot[pending])
        pending &= ~((cn[slot] > 0) & (tk[slot] == kmat).all(1))
        probe += pending
    slots = torch.unique(torch.cat(touched)) if touched else probe[:0]

    def sectors(s):
        """Distinct 32 B sectors of the counts and of the key rows of slots s."""
        if not s.numel():
            return 0, 0
        first, last = (4 * W * s) // 32, (4 * W * s + 4 * W - 1) // 32
        rows = torch.cat([(first + i)[first + i <= last]
                          for i in range(int((last - first).max()) + 1)])
        return torch.unique(s >> 3).numel(), torch.unique(rows).numel()

    n_cnt, n_key = sectors(slots)
    changed = slots[cn[slots] != cn0[slots]]
    claimed = changed[cn0[changed] == 0]
    w_cnt, _ = sectors(changed)
    _, w_key = sectors(claimed)
    return dict(probes=probes, slots=slots.numel(), count_sectors=n_cnt, key_sectors=n_key,
                sectors_written=w_cnt + w_key, bytes=32 * (n_cnt + n_key + w_cnt + w_key))


def cuda_ms_fresh(prepare, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn(*prepare())`` by CUDA events around
    ``fn`` alone (one warm-up): each run gets fresh inputs."""
    import torch

    fn(*prepare())
    times = []
    for _ in range(reps):
        args = prepare()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_queued(prepare, fn, reps: int = 5) -> float:
    """Median device milliseconds of ``fn(*prepare())`` (one warm-up): a
    sleep kernel of about a millisecond goes first, so the host has queued
    all of ``fn``'s work before the card reaches it, and the events around
    ``fn`` time the card's work alone, not the host's Python between its
    launches (which ``cuda_ms_fresh`` includes where it is the longer)."""
    import torch

    fn(*prepare())
    times = []
    for _ in range(reps):
        args = prepare()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_t1(dev):
    """T1 (the table insert from K3's key columns: validity and hash in
    the kernel, equal keys aggregated per warp) against its plain version
    (the torch validity and hash_words, then the probe rounds): one
    2^20-window batch of the table route into a 2^23-slot table that
    already holds the previous batches' keys, at k=51 (63 batches before
    it), k=13 and k=201 (7 before it), a poly-A batch (one key, every
    lane on one slot) and an AC-repeat batch (two keys in alternate
    lanes), as multisets of occupied (key row, count) pairs, with the
    table's invariants; then overfull 2^8-slot tables with max_probes=8
    and amounts 1-5, where the pending sets may differ: per key, stored
    count + pending amounts == input, no key in two slots, every stored
    key found by lookup.  Times the kernel and the plain version from the
    same table, with the bound: the key columns in and the pending bytes
    out once, plus each distinct 32 B sector of counts and key rows that
    the probe chains touch, read once and written once where it
    changed."""
    import torch
    from kaarme_tpu_torch.ops import cuda_table, hashing, sortcount, table

    per = TABLE_TILE * TABLE_BATCH_TILES
    out, err = {}, 0
    for k, before in ((51, 63), (13, 7), (201, 7), ("polyA", 0), ("AC", 0)):
        if k in ("polyA", "AC"):
            codes = torch.zeros(per + K - 1, dtype=torch.int32, device=dev)
            if k == "AC":
                codes[1::2] = 1
            label = f"{'poly-A' if k == 'polyA' else 'AC repeat'} k={K}"
            k = K
        else:
            # reads of 300 bp at k=201 (the long-k shape), else 150 bp
            codes = read_stream(dev, 4_600_000, (before + 1) * per + k - 1,
                                read_len=300 if k > 150 else 150, n_every=100_003)
            label = f"k={k}"
        W = (k + 15) // 16
        tk, cn = table.make_table(TABLE_LOG2, W, dev)
        for b in range(before):
            if int(cuda_table.table_insert(tk, cn, table_batch(codes, b, k)())[1]):
                raise AssertionError(f"T1 {label}: pending windows while filling the table")
        step = table_batch(codes, before, k)
        keys = step()
        # the route's key columns (K3), all that feeds T1
        win_ms = cuda_ms(step)
        del codes, step
        fresh = lambda: (tk.clone(), cn.clone())
        run = lambda t, c: cuda_table.table_insert(t, c, keys)
        run_plain = lambda t, c: cuda_table.table_insert_plain(t, c, keys)
        tk_k, cn_k = fresh()
        pk, nk = run(tk_k, cn_k)
        tk_p, cn_p = fresh()
        pp, np_ = run_plain(tk_p, cn_p)
        torch.cuda.synchronize()
        if int(nk) or int(np_) or bool(pk.any()) or bool(pp.any()):
            raise AssertionError(f"T1 {label}: pending {int(nk)} (kernel), {int(np_)} (plain)")
        rk = check_table(tk_k, cn_k, 64, f"T1 {label} kernel")
        rp = check_table(tk_p, cn_p, 64, f"T1 {label} plain")
        e = max_abs_err(list(rk), list(rp))
        if e:
            raise AssertionError(f"T1 {label}: kernel != plain multiset (max abs err {e})")
        err = max(err, e)
        valid = sortcount._is_sentinel_i32(keys) == 0
        n, nv = valid.shape[0], int(valid.sum())
        total = int(cn_k.to(torch.int64).sum()) - int(cn.to(torch.int64).sum())
        if total != nv:
            raise AssertionError(f"T1 {label}: counts grew by {total}, valid windows {nv}")
        ms = cuda_ms_fresh(fresh, run)
        plain_ms = cuda_ms_fresh(fresh, run_plain)
        # the u32 key words in, the pending bytes out, and the table's
        # distinct sectors that the probe chains touch (read once,
        # written once where changed); next to no arithmetic
        tr = table_traffic(cn, tk_k, cn_k, keys, valid, hashing.hash_words(keys), 64)
        probes = tr["probes"]
        nbytes = (4 * W + 1) * n + tr["bytes"]
        b = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bound_bytes=nbytes,
                 bound_ops=0.0)
        out[label] = dict(ms=ms, plain_ms=plain_ms, windows_ms=win_ms, **b)
        print(f"T1 table_insert {label} W={W}: {n} windows ({nv} valid) into 2^{TABLE_LOG2} "
              f"slots after {before} batches: {rk.shape[1]} keys stored (before: "
              f"{int((cn > 0).sum())}), == plain as multisets, no key in two slots, lookup "
              f"finds all; {probes} probes on {tr['slots']} distinct slots ({tr['count_sectors']} "
              f"count sectors, {tr['key_sectors']} key-row sectors, {tr['sectors_written']} "
              f"written); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b['bound_ms']:.4f} ms (bytes: {nbytes}); the batch's key columns (K3) from "
              f"its chunk {win_ms:.3f} ms")
        del tk, cn, tk_k, cn_k, tk_p, cn_p, keys, valid, rk, rp
        torch.cuda.empty_cache()
    t1_overfull(dev)
    main = out[f"k={K}"]
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                windows_ms=main["windows_ms"],
                k13_ms=out["k=13"]["ms"], k13_plain_ms=out["k=13"]["plain_ms"],
                k13_bound_ms=out["k=13"]["bound_ms"], k201_ms=out["k=201"]["ms"],
                k201_plain_ms=out["k=201"]["plain_ms"], k201_bound_ms=out["k=201"]["bound_ms"],
                polya_ms=out[f"poly-A k={K}"]["ms"], polya_plain_ms=out[f"poly-A k={K}"]["plain_ms"],
                polya_bound_ms=out[f"poly-A k={K}"]["bound_ms"],
                ac_ms=out[f"AC repeat k={K}"]["ms"],
                ac_plain_ms=out[f"AC repeat k={K}"]["plain_ms"],
                ac_bound_ms=out[f"AC repeat k={K}"]["bound_ms"],
                **{key: main[key] for key in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")})


def t1_overfull(dev):
    """T1 and its plain version on 2^8-slot tables with max_probes=8 and
    far more distinct keys than slots, from key columns laid out as K3
    writes them (invalid windows all-ones): the invariants on both."""
    import torch
    from kaarme_tpu_torch.ops import cuda_table, sortcount, table, windows

    done = []
    for k in (13, K, 201):
        codes = read_stream(dev, 4_600_000, 5000 + k - 1, read_len=300, n_every=997)
        tiles = codes.unfold(0, 1000 + k - 1, 1000)
        keys, valid, _ = windows.windows_with_hash(tiles, k)
        rows = torch.stack(keys, 1).masked_fill(~valid[:, None], 0xFFFFFFFF)
        keys = tuple(sortcount.i32(rows.T.contiguous()).unbind(0))
        g = torch.Generator(device=dev).manual_seed(SEED + k)
        amount = torch.randint(1, 6, valid.shape, generator=g, device=dev, dtype=torch.int32)
        want = key_totals([x[valid] for x in keys], amount[valid])
        W = len(keys)
        for name, fn in (("kernel", cuda_table.table_insert),
                         ("plain", cuda_table.table_insert_plain)):
            tk, cn = table.make_table(8, W, dev)
            pending, npend = fn(tk, cn, keys, amount=amount, max_probes=8)
            torch.cuda.synchronize()
            if int(npend) != int(pending.sum()) or not 0 < int(npend) < int(valid.sum()):
                raise AssertionError(f"T1 overfull k={k} {name}: pending {int(npend)} vs mask "
                                     f"{int(pending.sum())}")
            if bool((pending & ~valid).any()):
                raise AssertionError(f"T1 overfull k={k} {name}: an invalid window is pending")
            rows = check_table(tk, cn, 8, f"T1 overfull k={k} {name}")
            got = key_totals([torch.cat([r, x[pending].to(torch.int32)])
                              for r, x in zip(rows[:W], keys)],
                             torch.cat([rows[W], amount[pending]]))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"T1 overfull k={k} {name}: stored + pending != input")
            done.append(f"k={k} {name}: {rows.shape[1]} stored, {int(npend)} pending")
    print(f"T1 overfull 2^8 slots, max_probes=8, {want[0].shape[1]} distinct keys at k=201: "
          f"stored counts + pending amounts == input per key, no key in two slots, lookup "
          f"finds every stored key; {'; '.join(done)}")


BLOOM_U = 5_000_000        # -u of the full phase's -b runs: 2^28 bits a stage, 7 hash functions


def filter_words(keys, nwords: int):
    """Each valid key's filter word index (r1 & (nwords - 1), int64): the
    roots from the plain ``hash_words64``, validity as K3 writes it."""
    from kaarme_tpu_torch.ops import hashing, sortcount

    valid = sortcount._is_sentinel_i32(keys) == 0
    r1, _ = hashing.hash_words64(keys)
    return (r1 & (nwords - 1))[valid]


def changed_sectors(before, after) -> int:
    """32 B sectors of a filter whose words differ between two states."""
    import torch

    return torch.unique(torch.nonzero(before != after).flatten() >> 3).numel()


def b1_bound(keys, hfn: int, f0, f1) -> dict:
    """B1's least time on a batch: the 4W key bytes of every window read
    once, each distinct 32 B sector of both stages that the valid keys'
    words lie in read once and each changed one written once (filters f0
    before, f1 after), the two counters written once; against about 20
    operations a key word (two murmur3 blocks), 16 for the finalizers and
    3 a hash function per window."""
    import torch

    n, W = keys[0].shape[0], len(keys)
    read = torch.unique(filter_words(keys, f0[0].shape[0]) >> 3).numel()
    written = changed_sectors(f0[0], f1[0]) + changed_sectors(f0[1], f1[1])
    nbytes = 4 * W * n + 32 * (2 * read + written) + 16
    ops = float(n * (20 * W + 16 + 3 * hfn))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", bound_bytes=nbytes, bound_ops=ops, sectors_read=read,
                sectors_written=written)


def b2_bound(keys, gated, hfn: int, bf2) -> dict:
    """B2's least time on a batch: the 4W key bytes read once, each
    distinct BF2 sector the valid keys' words lie in read once, and the
    words of the keys it turned all-ones written once; operations as B1's."""
    from kaarme_tpu_torch.ops import sortcount

    n, W = keys[0].shape[0], len(keys)
    read = filter_words(keys, bf2.shape[0])
    missed = int(sortcount._is_sentinel_i32(gated).sum() - sortcount._is_sentinel_i32(keys).sum())
    nbytes = 4 * W * n + 32 * int((read >> 3).unique().numel()) + 4 * W * missed
    ops = float(n * (20 * W + 16 + 3 * hfn))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", bound_bytes=nbytes, bound_ops=ops, missed=missed)


def bloom_pair(dev, bits: int, keys, hfn: int, f0, scratch, label: str, timed_run: bool):
    """B1 and B2 against their plain versions on one batch of key
    columns: B1 from copies of the filters f0 (BF words and both counters
    equal), then B2 on copies of the keys against the BF2 after the
    insert (key words equal).  With ``timed_run``, both kernels and both
    plain versions are timed from fresh copies, with their bounds."""
    import torch
    from kaarme_tpu_torch.ops import cuda_bloom

    kf = [f.clone() for f in f0]
    pf = [f.clone() for f in f0]
    got = cuda_bloom.bloom_insert(kf[0], kf[1], keys, hfn, scratch)
    want = cuda_bloom.bloom_insert_plain(pf[0], pf[1], keys, hfn)
    e1 = max_abs_err(kf + [got[0].reshape(1), got[1].reshape(1)],
                     pf + [want[0].reshape(1), want[1].reshape(1)])
    if e1:
        raise AssertionError(f"B1 {label}: kernel != plain (max abs err {e1}): counters "
                             f"{[int(x) for x in got]} vs {[int(x) for x in want]}")
    base = torch.stack([k.to(torch.int32) for k in keys])
    gk = cuda_bloom.bloom_gate(kf[1], tuple(base.clone().unbind(0)), hfn)
    gp = cuda_bloom.bloom_gate_plain(kf[1], tuple(base.clone().unbind(0)), hfn)
    e2 = max_abs_err(gk, gp)
    if e2:
        raise AssertionError(f"B2 {label}: kernel != plain (max abs err {e2})")
    res = dict(max_abs_err=max(e1, e2), new=[int(x) for x in got], filters=kf)
    if timed_run:
        fresh = lambda: tuple(f.clone() for f in f0)
        gate_fresh = lambda: (tuple(base.clone().unbind(0)),)
        b1 = lambda a, b: cuda_bloom.bloom_insert(a, b, keys, hfn, scratch)
        b2 = lambda k: cuda_bloom.bloom_gate(kf[1], k, hfn)
        # ms: the call, the host's Python included; dev_ms: the card's time
        # alone (the launches queued behind a sleep)
        res.update(
            b1=dict(ms=cuda_ms_fresh(fresh, b1), dev_ms=cuda_ms_queued(fresh, b1),
                    plain_ms=cuda_ms_fresh(fresh, lambda a, b: cuda_bloom.bloom_insert_plain(
                        a, b, keys, hfn)), **b1_bound(keys, hfn, f0, kf)),
            b2=dict(ms=cuda_ms_fresh(gate_fresh, b2), dev_ms=cuda_ms_queued(gate_fresh, b2),
                    plain_ms=cuda_ms_fresh(gate_fresh, lambda k: cuda_bloom.bloom_gate_plain(
                        kf[1], k, hfn)), **b2_bound(keys, gk, hfn, kf[1])))
    return res


def phase_bloom(dev):
    """B1 (the -b pass-1 insert) and B2 (the pass-2 gate) against their
    plain versions (docstring item 12)."""
    import torch
    from kaarme_tpu_torch.models import bloom_counter
    from kaarme_tpu_torch.ops import bloom, cuda_bloom, sortcount

    bits, hfn, _, _ = bloom_counter.make_filters(BLOOM_U, 0.01, "cpu")
    per = TABLE_TILE * TABLE_BATCH_TILES
    before = 63
    codes = read_stream(dev, 4_600_000, (before + 1) * per + K - 1, n_every=100_003)
    # the table's pass-1 loop, the step (K3 + B1) under sync debug "error":
    # any host synchronisation inside it raises; the plain route's step
    # (unpack, plain K3, torch hash, unique and bit planes) beside it
    kf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    pf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    scratch = cuda_bloom.scratch_for(per, dev)
    new_k, new_p = [0, 0], [0, 0]
    cuda_bloom.bloom_insert.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(before):
        packed, bitmap = chunk_of(codes[b * per: (b + 1) * per + K - 1])
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, n1, n2 = sortcount.bloom_pass1_superstep(kf[0], kf[1], packed, bitmap, k=K,
                                                           n=per, hfn=hfn, scratch=scratch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        new_k = [new_k[0] + n1, new_k[1] + n2]
        _, _, n1, n2 = sortcount.bloom_pass1_superstep(pf[0], pf[1], packed, bitmap, k=K, n=per,
                                                       hfn=hfn, kernels="plain")
        new_p = [new_p[0] + n1, new_p[1] + n2]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    err = max_abs_err(kf + [torch.stack(new_k)], pf + [torch.stack(new_p)])
    if err or cuda_bloom.bloom_insert.launches != before:
        raise AssertionError(f"B1 table pass-1 loop: kernel route != plain route (max abs err "
                             f"{err}), {cuda_bloom.bloom_insert.launches} launches")
    print(f"B1 table pass-1 loop: {before} batches of {per} windows at k={K}, {bits} bits x 2, "
          f"{hfn} hash functions: K3 + B1 under torch.cuda.set_sync_debug_mode('error') (no "
          f"host synchronisation), BF1, BF2 and counters {[int(x) for x in new_k]} == the plain "
          f"route's; both routes {loop_s:.3f} s")
    del pf
    keys = table_batch(codes, before, K)()
    del codes
    main = bloom_pair(dev, bits, keys, hfn, kf, scratch, f"table batch k={K}", True)
    main.pop("filters")
    out = {"table": main}
    del keys, kf, main
    torch.cuda.empty_cache()

    # two sort supersteps of 2^26 windows (the sort routes' pass 1): the
    # first on empty filters (every root ranked in the scratch set), the
    # second on the filters after the first; one scratch for both
    codes = read_stream(dev, 4_600_000, 2 * N_WINDOWS + K - 1, n_every=100_003)
    scratch = cuda_bloom.scratch_for(N_WINDOWS, dev)
    sf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    for s in range(2):
        packed, bitmap = chunk_of(codes[s * N_WINDOWS: (s + 1) * N_WINDOWS + K - 1])
        keys = sortcount.window_keys_from_chunk(packed, bitmap, k=K, n=N_WINDOWS)
        del packed, bitmap
        res = bloom_pair(dev, bits, keys, hfn, sf, scratch, f"superstep {s} k={K}", True)
        sf = res.pop("filters")
        out[f"superstep{s}"] = res
        del keys
        torch.cuda.empty_cache()
    print(f"B1 scratch for a {N_WINDOWS}-window superstep: {scratch.buf.numel() * 4} B "
          f"({scratch.slots} slots of 16 B, then the decisions)")
    del codes, sf, scratch, res
    torch.cuda.empty_cache()

    # the epoch wrap: one scratch, table batches 0-2 at epochs 1-3, then
    # from EPOCH_MAX - 2 batches 3-8 across the wrap to 1, whose slots of
    # epochs 1-3 must be cleared; kernel == plain after every batch
    codes = read_stream(dev, 4_600_000, 9 * per + K - 1, n_every=100_003)
    kf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    pf = [bloom.make_bloom(bits, dev) for _ in range(2)]
    scratch = cuda_bloom.scratch_for(per, dev)
    epochs = []
    for b in range(9):
        if b == 3:
            scratch.epoch = cuda_bloom.EPOCH_MAX - 2
        keys = table_batch(codes, b, K)()
        got = cuda_bloom.bloom_insert(kf[0], kf[1], keys, hfn, scratch)
        want = cuda_bloom.bloom_insert_plain(pf[0], pf[1], keys, hfn)
        epochs.append(scratch.epoch)
        err = max_abs_err(kf + [torch.stack(got)], pf + [torch.stack(want)])
        if err:
            raise AssertionError(f"B1 epoch wrap, batch {b} at epoch {scratch.epoch}: kernel != "
                                 f"plain (max abs err {err})")
    print(f"B1 epoch wrap: 9 table batches at epochs {epochs}, kernel == plain after each")
    del codes, kf, pf, scratch
    torch.cuda.empty_cache()

    # edge cases: a 2^10-bit filter under heavy collision, poly-A (one
    # root 2^20 times), k=201 and k=13 on a tail of no whole block
    edges = []
    for label, k, n, ebits, reads in (("2^10-bit filter k=31", 31, per, 1 << 10, 150),
                                      (f"poly-A k={K}", K, per, bits, 0),
                                      ("k=201", 201, 100_003, 1 << 20, 300),
                                      ("k=13 tail", 13, 777, 1 << 16, 150)):
        f = [bloom.make_bloom(ebits, dev) for _ in range(2)]
        scratch = cuda_bloom.scratch_for(n, dev)
        for b in range(2):
            if reads:
                c = read_stream(dev, 20_000, 2 * n + k - 1, read_len=reads, n_every=9_973)
                c = c[b * n: (b + 1) * n + k - 1]
            else:
                c = torch.zeros(n + k - 1, dtype=torch.int32, device=dev)
            packed, bitmap = chunk_of(c)
            keys = sortcount.window_keys_from_chunk(packed, bitmap, k=k, n=n)
            res = bloom_pair(dev, ebits, keys, hfn, f, scratch, f"{label} batch {b}", False)
            f = res["filters"]
        edges.append(f"{label}: counters {res['new']}")
    print(f"B1, B2 edge cases, kernel == plain over two batches each: {'; '.join(edges)}")

    for name, r in out.items():
        for kern in ("b1", "b2"):
            d = r[kern]
            print(f"{kern.upper()} {name} k={K}: kernel {d['ms']:.4f} ms (on the card "
                  f"{d['dev_ms']:.4f}), plain {d['plain_ms']:.3f} "
                  f"ms, bound {d['bound_ms']:.4f} ms, share {d['bound_ms'] / d['ms']:.3f} "
                  f"(on the card {d['bound_ms'] / d['dev_ms']:.3f}) "
                  f"({d['bound_by']}: {d['bound_bytes']} B, "
                  f"{d['bound_ops']:.0f} ops" + (f"; {d['sectors_read']} sectors of each stage "
                                                 f"read, {d['sectors_written']} written"
                                                 if kern == "b1" else
                                                 f"; {d['missed']} keys gated") + ")"
                  + (f"; counters {r['new']}" if kern == "b1" else ""))
    keys_of = ("bound_ms", "bound_by", "bound_bytes", "bound_ops")
    err = max(r["max_abs_err"] for r in out.values())
    return [dict(max_abs_err=err, ms=out["table"][kern]["ms"],
                 dev_ms=out["table"][kern]["dev_ms"],
                 plain_ms=out["table"][kern]["plain_ms"],
                 superstep_ms=out["superstep1"][kern]["ms"],
                 superstep_dev_ms=out["superstep1"][kern]["dev_ms"],
                 superstep_plain_ms=out["superstep1"][kern]["plain_ms"],
                 superstep_bound_ms=out["superstep1"][kern]["bound_ms"],
                 superstep_empty_ms=out["superstep0"][kern]["ms"],
                 superstep_empty_dev_ms=out["superstep0"][kern]["dev_ms"],
                 superstep_empty_plain_ms=out["superstep0"][kern]["plain_ms"],
                 superstep_empty_bound_ms=out["superstep0"][kern]["bound_ms"],
                 **{key: out["table"][kern][key] for key in keys_of})
            for kern in ("b1", "b2")]


def write_reads_fasta(path, genome_len: int, coverage: int, read_len: int = 150,
                      seed: int = SEED):
    """The reference's example shape (examples/make_example.py): a random
    genome sampled into fixed-length reads; returns (n_reads, reads)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    n_reads = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len, n_reads)
    reads = np.frombuffer(b"ACGT", np.uint8)[genome[starts[:, None] + np.arange(read_len)]]
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, reads[i].tobytes()) for i in range(n_reads)))
    return n_reads, reads


def golden(reads, k: int) -> dict:
    """String-based canonical k-mer counts (independent of the port)."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = {}
    for r in reads:
        s = r.tobytes()
        rc = s.translate(comp)[::-1]
        n = len(s)
        for i in range(n - k + 1):
            f, b = s[i:i + k], rc[n - k - i:n - i]
            km = f if f <= b else b
            out[km] = out.get(km, 0) + 1
    return out


def phase_small(tmp):
    from kaarme_tpu_torch import cli

    path = os.path.join(tmp, "small.fa")
    _, reads = write_reads_fasta(path, 20_000, 10)
    routes = [(31, []), (51, []), (13, []), (31, ["--pipeline", "classic", "--compactor", "merge"])]
    for k, extra in routes:
        gold = golden(reads, k)
        for mode, abu in ((0, 1), (2, 2)):
            out = os.path.join(tmp, f"small_{k}_{mode}.txt")
            rc, _ = cli.run([path, str(k), "-s", "100000", "-m", str(mode), "-a", str(abu),
                             "-q", "-o", out] + extra)
            if rc:
                raise AssertionError(f"small CLI run k={k} {extra} -m {mode} exited {rc}")
            clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
            want = {km: clip(c) for km, c in gold.items() if clip(c) >= abu}
            with open(out, "rb") as f:
                got = {ln.split()[0]: int(ln.split()[1]) for ln in f.read().splitlines()}
            if got != want:
                raise AssertionError(f"small CLI k={k} {extra} -m {mode}: {len(got)} k-mers "
                                     f"vs golden {len(want)}")
            print(f"small end to end k={k} {' '.join(extra)} -m {mode} -a {abu}: "
                  f"{len(got)} k-mers == golden")
    # the slotted skm layout at S=8: tiles overflow and the S-ladder replays
    out = os.path.join(tmp, "small_slotted.txt")
    counter, launches = counted(
        lambda: slotted_count([path, "31", "-s", "100000", "-a", "1", "-q"], out, S=8),
        "small k=31 slotted S=8", ("skm_slotted", "segsum_compact", "format_lines"),
        quiet=True)
    want = golden(reads, 31)
    with open(out, "rb") as f:
        got = {ln.split()[0]: int(ln.split()[1]) for ln in f.read().splitlines()}
    ladder = counter.stats["slot_grow_events"]
    if got != want or ladder < 1 or launches["skm_dense"]:
        raise AssertionError(f"small slotted S=8: {len(got)} k-mers vs golden {len(want)}, "
                             f"ladder events {ladder}, launches {launches}")
    print(f"small end to end k=31 slotted skm_slots=8: {len(got)} k-mers == golden; "
          f"S-ladder events {ladder} (S now {counter._S}), K5 launches "
          f"{launches['skm_slotted']} for {counter.stats['batches']} supersteps")


def launch_counters():
    from kaarme_tpu_torch.ops import (cuda_bloom, cuda_compact, cuda_expand, cuda_merge,
                                      cuda_parse, cuda_skm, cuda_table, cuda_winkeys, writer)

    return {"skm_dense": cuda_skm.run_rows_dense,
            "segsum_compact": cuda_compact.segsum_compact,
            "window_keys": cuda_winkeys.window_keys,
            "merge_compact": cuda_merge.merge_compact,
            "skm_slotted": cuda_skm.run_rows_slotted,
            "table_insert": cuda_table.table_insert,
            "format_lines": writer.format_lines,
            "bloom_insert": cuda_bloom.bloom_insert,
            "bloom_gate": cuda_bloom.bloom_gate,
            "expand_runs": cuda_expand.expand_runs,
            "parse_pack": cuda_parse.parse_pack}


@contextlib.contextmanager
def plain_bloom_calls():
    """Counts, while the block runs, the calls of what B1 and B2 replace
    on the -b path: ``hashing.hash_words`` (its own counter),
    ``torch.unique`` and ``ops/bloom.set_bits`` (wrapped for the block).
    Yields the dict of counts, filled in when the block ends."""
    import torch
    from kaarme_tpu_torch.ops import bloom, hashing

    counts = {"hash_words": 0, "torch.unique": 0, "set_bits": 0}
    saved = [(torch, "unique", torch.unique), (bloom, "set_bits", bloom.set_bits)]

    def counting(key, fn):
        def wrapper(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapper

    torch.unique = counting("torch.unique", torch.unique)
    bloom.set_bits = counting("set_bits", bloom.set_bits)
    hashing.hash_words.calls = 0
    try:
        yield counts
    finally:
        counts["hash_words"] = hashing.hash_words.calls
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def slotted_count(argv, out_path: str, S=None):
    """The slotted skm counter (no CLI flag: the library API) configured
    as the CLI would configure the skm route for ``argv``; counts the
    file and writes the count file.  Returns the counter."""
    from kaarme_tpu_torch import cli
    from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig

    args = cli.build_parser().parse_args(argv)
    err = cli.validate(args)
    if err or args.pipeline != "skm":
        raise AssertionError(f"slotted run {argv}: {err or 'not the skm route'}")
    kw = cli.config_kwargs(args)
    if S:
        kw["skm_slots"] = S
    counter = SkmCounter(SkmCounterConfig(segpack="slotted", **kw))
    counter.count_file(args.INPUT)
    counter.write_output(out_path)
    return counter


def counted(fn, label: str, uses=(), quiet: bool = False):
    """Run ``fn() -> counter`` with every launch counter set to 0 just
    before it and read just after; fails if a kernel of ``uses`` was not
    launched.  Returns (counter, launches)."""
    import torch

    fns = launch_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counter = fn()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    skipped = [u for u in uses if launches[u] < 1]
    if skipped:
        raise AssertionError(f"{label}: the path launched no {skipped}: {launches}")
    if quiet:
        return counter, launches
    st = counter.stats
    fin = st.get("finalize_seconds")
    bloom = ""
    if "new_in_second" in st:
        pass1 = f"{st['bloom_pass1_seconds']:.3f} s" + (
            f" ({st['pass1_batches']} supersteps)" if "pass1_batches" in st else "")
        bloom = (f"; Bloom pass 1 {pass1}, new_in_first {st['new_in_first']}, new_in_second "
                 f"{st['new_in_second']}, {st['bloom_bits']} bits x 2, "
                 f"{st['bloom_hash_functions']} hash functions")
    if "replayed_supersteps" not in st:
        # the probe table
        used, cap = counter.occupancy()
        print(f"full size {label}: count {st['build_seconds']:.3f} s "
              f"({st['windows_processed'] / st['build_seconds']:.0f} windows/s), write "
              f"{st['write_seconds']:.3f} s, wall {wall:.3f} s, peak device memory {peak} bytes; "
              f"batches {st['batches']}, grow events {st['grow_events']}, occupancy "
              f"{used}/{cap}; launches {launches}" + bloom)
        return counter, launches
    print(f"full size {label}: count {st['build_seconds']:.3f} s "
          f"({st['windows_processed'] / st['build_seconds']:.0f} windows/s), write "
          f"{st['write_seconds']:.3f} s"
          + (f" (finalize {fin:.3f} s of it)" if fin is not None else "")
          + f", wall {wall:.3f} s, peak device memory {peak} bytes; supersteps "
          f"{st['batches']} (+{st['replayed_supersteps']} replayed), store grow events "
          f"{st['grow_events']}; launches {launches}"
          + bloom)
    return counter, launches


def run_full(argv, label: str, uses=()):
    """One CLI run through ``counted``: its count file written by W1, or
    under ``--kernels plain`` with no W1 and no E1 launch."""
    from kaarme_tpu_torch import cli

    def go():
        rc, counter = cli.run(argv)
        if rc:
            raise AssertionError(f"full-size CLI run {label} exited {rc}")
        return counter

    plain = "--kernels" in argv and argv[argv.index("--kernels") + 1] == "plain"
    counter, launches = counted(go, label, uses if plain else (*uses, "format_lines"))
    if plain and (launches["format_lines"] or launches["expand_runs"]):
        raise AssertionError(f"{label}: W1 launched {launches['format_lines']} times, E1 "
                             f"{launches['expand_runs']}")
    return counter, launches


def same_file(a: str, b: str, what: str):
    if not filecmp.cmp(a, b, shallow=False):
        raise AssertionError(f"count file differs: {what}")
    print(f"full size: byte-identical count files, {what}")


def check_launches(counter, launches, label: str, route: str, bloom: bool = False):
    """K3 and K4 launched once per dispatched superstep of their route
    (replays included), K3 also once per Bloom pass-1 superstep; with -b,
    B1 once per pass-1 superstep and B2 once per pass-2 gate: per
    dispatched classic superstep, at least once in the skm finalize; E1
    once per skm finalize chunk attempt (``finalize_chunks``)."""
    st = counter.stats
    steps = st["batches"] + st["replayed_supersteps"]
    pass1 = st.get("pass1_batches", 0) if bloom else 0
    # the skm finalize gates each expansion chunk: at least one
    gate = max(launches["bloom_gate"], 1) if route == "skm" else steps
    want = {"window_keys": pass1 + (0 if route == "skm" else steps),
            "merge_compact": steps if route == "merge" else 0,
            "bloom_insert": pass1,
            "bloom_gate": gate if bloom else 0,
            "expand_runs": st.get("finalize_chunks", 0) if route == "skm" else 0}
    got = {name: launches[name] for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want} ({st['batches']} supersteps, "
                             f"{st['replayed_supersteps']} replayed, {pass1} pass-1 supersteps)")
    print(f"full size {label}: launches {got} ({st['batches']} supersteps + "
          f"{st['replayed_supersteps']} replayed" + (f", {pass1} pass-1 supersteps" if bloom
                                                      else "") + ")")


def same_counts(a: str, b: str, what: str):
    """The two count files hold the same lines in any order (the probe
    table writes slot order), by the port's ``utils/compare.py``."""
    from kaarme_tpu_torch.utils import compare

    equal, diffs = compare.compare_count_files(a, b)
    if not equal:
        raise AssertionError(f"count files differ: {what}: {diffs}")
    print(f"full size: equal count files once sorted, {what}")


def table_runs(path: str, out, n_reads: int, distinct: int):
    """The probe table (--backend table) at full size: k=51 (== the skm
    route's file, sorted), the same with --kernels plain (== the kernel
    run), k=13 (== the classic k=13 file; counts sum to the valid
    windows), and -b -u 5000000 -a 2 (== the skm -b file).  T1 launched
    once per batch (plus two per grow) and K3 once per batch, pass-1
    batch and grow on the kernel runs, B1 and B2 once per batch of the
    -b run, none of them on the plain one.  Returns
    T1's launches in the k=51 run and (B1, B2)'s in the -b run."""

    def run(argv, label, plain=False):
        bloom = "-b" in argv
        uses = ("table_insert", "window_keys") + (("bloom_insert", "bloom_gate") if bloom else ())
        with plain_bloom_calls() as calls:
            counter, launches = run_full(argv + (["--kernels", "plain"] if plain else []), label,
                                         () if plain else uses)
        st = counter.stats
        got = tuple(launches[u] for u in uses)
        # pass 1 runs the table's batches: as many as pass 2's
        want = (0,) * len(uses) if plain else (
            st["batches"] + 2 * st["grow_events"],
            st["batches"] * (2 if bloom else 1) + st["grow_events"]) + (st["batches"],) * (
                2 if bloom else 0)
        if got != want:
            raise AssertionError(f"{label}: launches of {uses}: {got} != {want} for "
                                 f"{st['batches']} batches ({'and as many pass-1 batches, ' if bloom else ''}"
                                 f"{st['grow_events']} grow events)")
        # T1, B1 and B2 hash in the kernels: no torch hash, unique or bit
        # plane on the kernel route (the plain route's are torch ops)
        if not plain and any(calls.values()):
            raise AssertionError(f"{label}: the count step called {calls}")
        print(f"full size {label}: launches of {uses} {got}; {calls}"
              + ("" if plain else " (T1, B1 and B2 hash in the kernels)"))
        return counter, got

    argv = [path, str(K), "-s", "8000000", "-a", "1", "-q", "--backend", "table"]
    counter, (t1, _) = run(argv + ["-o", out("table")], f"k={K} --backend table")
    _, cnt = counter.dump()
    used = counter.occupancy()[0]
    if used != distinct or int(cnt.sum()) != n_reads * (150 - K + 1):
        raise AssertionError(f"table k={K}: {used} distinct, sum {int(cnt.sum())}")
    del counter, cnt
    same_counts(out("skm"), out("table"), f"k={K} --backend table == skm ({distinct} distinct)")
    run(argv + ["-o", out("table_plain")], f"k={K} --backend table, plain", plain=True)
    same_counts(out("table"), out("table_plain"), f"k={K} --backend table kernels == plain")

    argv = [path, "13", "-s", "8000000", "-a", "1", "-q", "--backend", "table"]
    counter, _ = run(argv + ["-o", out("table_k13")], "k=13 --backend table")
    _, cnt = counter.dump()
    if int(cnt.sum()) != n_reads * (150 - 13 + 1):
        raise AssertionError(f"table k=13: sum of counts {int(cnt.sum())} != valid windows")
    print(f"full size k=13 --backend table: occupancy {counter.occupancy()}, sum of counts "
          f"{int(cnt.sum())} == valid windows")
    del counter, cnt
    same_counts(out("k13"), out("table_k13"), "k=13 --backend table == classic")

    argv = [path, str(K), "-b", "-u", "5000000", "-a", "2", "-q", "--backend", "table"]
    counter, got = run(argv + ["-o", out("table_bloom")],
                       f"k={K} -b -u 5000000 -a 2 --backend table")
    if not 0 < counter.stats["new_in_second"]:
        raise AssertionError("table -b: no second occurrences")
    del counter
    same_counts(out("bloom_skm"), out("table_bloom"), f"k={K} -b --backend table == skm -b")
    return t1, got[2:]


def phase_full(tmp):
    path = os.path.join(tmp, "ecoli30x.fa")
    t0 = time.perf_counter()
    n_reads, _ = write_reads_fasta(path, 4_600_000, 30)
    print(f"full size input: {n_reads} reads x 150 bp (30x of 4.6 Mb), "
          f"{os.path.getsize(path)} bytes, written in {time.perf_counter() - t0:.3f} s")
    out = lambda name: os.path.join(tmp, name + ".txt")

    # the skm route (k >= 16 under auto)
    argv = [path, str(K), "-s", "8000000", "-a", "1", "-q"]
    counter, skm_launches = run_full(argv + ["-o", out("skm")], f"k={K} skm",
                                     ("skm_dense", "segsum_compact", "expand_runs",
                                      "parse_pack"))
    _, cnt = counter.dump()
    windows = n_reads * (150 - K + 1)
    if int(cnt.sum()) != windows:
        raise AssertionError(f"sum of counts {int(cnt.sum())} != valid windows {windows}")
    distinct = counter.distinct_kmers()
    if distinct != DISTINCT_K51:
        raise AssertionError(f"k={K}: {distinct} distinct, expected {DISTINCT_K51}")
    st = counter.stats
    k1 = skm_launches["skm_dense"]
    if k1 != st["batches"] + st["replayed_supersteps"]:
        raise AssertionError(f"skm: K1 launched {k1} times for {st['batches']} supersteps and "
                             f"{st['replayed_supersteps']} replays")
    if skm_launches["expand_runs"] != st["finalize_chunks"]:
        raise AssertionError(f"skm: E1 launched {skm_launches['expand_runs']} times for "
                             f"{st['finalize_chunks']} finalize chunks")
    print(f"full size k={K} skm: distinct {distinct}, sum of counts {int(cnt.sum())} == "
          f"valid windows; run-row overflow events {st['slot_grow_events']}; K1 launched on "
          f"every superstep: {k1} launches = {st['batches']} supersteps + "
          f"{st['replayed_supersteps']} replayed; E1 launched once per finalize chunk: "
          f"{skm_launches['expand_runs']}")
    del counter
    run_full(argv + ["-o", out("skm_plain"), "--kernels", "plain"], f"k={K} skm, plain")
    same_file(out("skm"), out("skm_plain"), f"k={K} skm kernels == plain")

    # the slotted skm layout (K5), configured as the CLI configures skm
    counter, slotted_launches = counted(lambda: slotted_count(argv, out("slotted")),
                                        f"k={K} skm slotted S=96",
                                        ("skm_slotted", "segsum_compact", "format_lines",
                                         "expand_runs"))
    st = counter.stats
    k5 = slotted_launches["skm_slotted"]
    if (slotted_launches["skm_dense"] or k5 != st["batches"] + st["replayed_supersteps"]
            or slotted_launches["expand_runs"] != st["finalize_chunks"]):
        raise AssertionError(f"slotted: K5 launched {k5} times for {st['batches']} supersteps "
                             f"and {st['replayed_supersteps']} replays: {slotted_launches}")
    print(f"full size k={K} skm slotted: K5 launched on every superstep: {k5} launches = "
          f"{st['batches']} supersteps + {st['replayed_supersteps']} replayed; final S "
          f"{counter._S}, S-ladder events {st['slot_grow_events']}")
    del counter
    same_file(out("skm"), out("slotted"), f"k={K} skm slotted == skm dense")

    # the classic route at k=51, with and without the linear merge
    classic = argv + ["--pipeline", "classic"]
    counter, classic_launches = run_full(classic + ["-o", out("classic")],
                                         f"k={K} classic", ("window_keys", "segsum_compact"))
    if counter.n_distinct != distinct:
        raise AssertionError(f"classic k={K}: {counter.n_distinct} distinct != {distinct}")
    check_launches(counter, classic_launches, f"k={K} classic", "classic")
    same_file(out("skm"), out("classic"), f"k={K} classic == skm ({distinct} distinct)")
    counter, merge_launches = run_full(classic + ["--compactor", "merge", "-o", out("merge")],
                                       f"k={K} classic --compactor merge",
                                       ("window_keys", "merge_compact"))
    check_launches(counter, merge_launches, f"k={K} classic --compactor merge", "merge")
    same_file(out("skm"), out("merge"), f"k={K} classic --compactor merge == skm")

    # k=13: the classic route is the only one (separate-count layout)
    argv = [path, "13", "-s", "8000000", "-a", "1", "-q"]
    counter, launches = run_full(argv + ["-o", out("k13")], "k=13 classic",
                                 ("window_keys", "segsum_compact"))
    check_launches(counter, launches, "k=13 classic", "classic")
    _, cnt = counter.dump()
    if int(cnt.sum()) != n_reads * (150 - 13 + 1):
        raise AssertionError(f"k=13: sum of counts {int(cnt.sum())} != valid windows")
    print(f"full size k=13 classic: distinct {counter.n_distinct}, sum of counts "
          f"{int(cnt.sum())} == valid windows")
    del counter, cnt
    run_full(argv + ["-o", out("k13_plain"), "--kernels", "plain"], "k=13 classic, plain")
    same_file(out("k13"), out("k13_plain"), "k=13 kernels == plain")
    counter, launches = run_full(argv + ["--compactor", "merge", "-o", out("k13_merge")],
                                 "k=13 classic --compactor merge",
                                 ("window_keys", "merge_compact"))
    check_launches(counter, launches, "k=13 classic --compactor merge", "merge")
    del counter
    same_file(out("k13"), out("k13_merge"), "k=13 --compactor merge == sort + K2")

    # the two-pass Bloom prefilter: the -a 1 file without its count-1 lines
    with open(out("skm"), "rb") as f, open(out("ge2"), "wb") as g:
        g.writelines(ln for ln in f if not ln.endswith(b" 1\n"))
    bloom = [path, str(K), "-b", "-u", "5000000", "-a", "2", "-q"]
    bloom_launches = {}
    for name, route, extra, uses in (
            ("bloom_skm", "skm", [], ("window_keys", "skm_dense", "segsum_compact",
                                      "expand_runs")),
            ("bloom_classic", "classic", ["--pipeline", "classic"],
             ("window_keys", "segsum_compact")),
            ("bloom_merge", "merge", ["--pipeline", "classic", "--compactor", "merge"],
             ("window_keys", "merge_compact"))):
        label = f"k={K} -b -u 5000000 -a 2 {' '.join(extra) or 'skm'}"
        with plain_bloom_calls() as calls:
            counter, launches = run_full(bloom + extra + ["-o", out(name)], label,
                                         (*uses, "bloom_insert", "bloom_gate"))
        if counter.bf1 is not None or not 0 < counter.stats["new_in_second"]:
            raise AssertionError(f"{name}: BF1 kept or no second occurrences")
        check_launches(counter, launches, label, route, bloom=True)
        if any(calls.values()):
            raise AssertionError(f"{label}: the plain Bloom chain ran: {calls}")
        print(f"full size {label}: {calls} (B1 and B2 hash in the kernels)")
        bloom_launches[name] = (launches["bloom_insert"], launches["bloom_gate"])
        del counter
        same_file(out("ge2"), out(name), f"k={K} {name} -a 2 == -a 1 without count-1 lines")
    launches = {"skm_dense": skm_launches["skm_dense"],
                "segsum_compact": skm_launches["segsum_compact"],
                "window_keys": classic_launches["window_keys"],
                "merge_compact": merge_launches["merge_compact"],
                "skm_slotted": slotted_launches["skm_slotted"],
                "format_lines": skm_launches["format_lines"],
                "expand_runs": skm_launches["expand_runs"]}
    launches["table_insert"], bloom_launches["table"] = table_runs(path, out, n_reads, distinct)
    launches["bloom_insert"], launches["bloom_gate"] = bloom_launches["table"]
    print(f"full size -b runs, (B1, B2) launches: {bloom_launches}")
    files = {"input": path, "skm": out("skm"), "k13": out("k13"), "n_reads": n_reads}
    return launches, files


def sharded_kwargs(path: str, k: int, ndev: int, extra=()):
    """The sharded counter's configuration as the CLI sizes ``--devices
    ndev`` for this file at ``-s 8000000 -a 1``; returns (pipeline,
    keyword arguments)."""
    from kaarme_tpu_torch import cli

    args = cli.build_parser().parse_args(
        [path, str(k), "-s", "8000000", "-a", "1", "-q", "--devices", str(ndev), *extra])
    err = cli.validate(args)
    if err:
        raise AssertionError(f"sharded sizing k={k} --devices {ndev}: {err}")
    return args.pipeline, cli.sharded_config_kwargs(args)


def sharded_run(make, path: str, out_path: str, label: str, uses):
    """Phase 9's one run: count the full-size file on ``make()``'s shards,
    finalize (the exchange) and write, with every launch counter set to 0
    just before and read just after; fails if a kernel of ``uses`` was
    not launched (W1 always: the count file).  Prints the times, memory,
    rounds and the balance.  Returns (counter, launches)."""
    import torch

    uses = (*uses, "format_lines")
    fns = launch_counters()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counter = make()
    counter.count_file(path)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    table = not hasattr(counter, "finalize_exchange")
    if not table:
        counter.finalize_exchange()
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    counter.write_output(out_path)
    t3 = time.perf_counter()
    launches = {name: f.launches for name, f in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    skipped = [u for u in uses if launches[u] < 1]
    if skipped:
        raise AssertionError(f"{label}: the path launched no {skipped}: {launches}")
    st = counter.stats
    if table:
        shards = [int((cn > 0).sum()) for _, cn in counter.tables]
        steps = (f"batches {st['batches']}, grow events {st['grow_events']}, occupancy "
                 f"{counter.occupancy()}")
    else:
        shards = list(counter._nd)
        steps = (f"rounds {st['batches']} (+{st['replayed_rounds']} replayed), grow events "
                 f"{st['grow_events']}, slot-grow events {st.get('slot_grow_events', '-')}")
    print(f"sharded {label}: count {t1 - t0:.3f} s "
          f"({st['windows_processed'] / (t1 - t0):.0f} windows/s), finalize/exchange "
          f"{t2 - t1:.3f} s, write {t3 - t2:.3f} s, wall {t3 - t0:.3f} s, peak device memory "
          f"{peak} bytes; {steps}; distinct per shard {shards}; launches {launches}")
    return counter, launches


def phase_sharded(files: dict):
    """Phase 9: the sharded counters (``kaarme_tpu_torch/parallel``) on the
    full-size file, 2 and 4 shards on cuda:0 (the real routing, exchange
    and kernels on every shard), sized as the CLI sizes ``--devices``;
    each count file == the single-device route's; a checkpoint saved
    mid-stream on 4 shards and resumed on 2 == the uninterrupted run; the
    CLI's --devices 2 on one card exits 1."""
    import torch

    from kaarme_tpu_torch import parallel
    from kaarme_tpu_torch.io import reader as io_reader

    dev = torch.device("cuda", 0)
    path, tmp = files["input"], os.path.dirname(files["input"])
    out = lambda name: os.path.join(tmp, name + ".txt")
    for ndev in (2, 4):
        _, kw = sharded_kwargs(path, K, ndev)
        label = f"k={K} skm on {ndev} shards"
        counter, launches = sharded_run(
            lambda: parallel.ShardedSkmCounter(parallel.ShardedSkmConfig(**kw), (dev,) * ndev),
            path, out(f"sharded_skm{ndev}"), label,
            ("skm_slotted", "segsum_compact", "expand_runs"))
        st = counter.stats
        if launches["skm_slotted"] != ndev * (st["batches"] + st["replayed_rounds"]):
            raise AssertionError(f"{label}: K5 launched {launches['skm_slotted']} times")
        del counter
        same_file(files["skm"], out(f"sharded_skm{ndev}"), f"{label} == skm")

    _, kw = sharded_kwargs(path, K, 2, ["--pipeline", "classic", "--compactor", "merge"])
    label = f"k={K} classic --compactor merge on 2 shards"
    counter, launches = sharded_run(
        lambda: parallel.ShardedSortCounter(parallel.ShardedSortConfig(**kw), (dev,) * 2),
        path, out("sharded_merge2"), label, ("window_keys", "merge_compact", "segsum_compact"))
    st = counter.stats
    steps = 2 * (st["batches"] + st["replayed_rounds"])
    if launches["window_keys"] != steps or launches["merge_compact"] != steps:
        raise AssertionError(f"{label}: K3 {launches['window_keys']}, K4 "
                             f"{launches['merge_compact']} launches for {steps} shard steps")
    del counter
    same_file(files["skm"], out("sharded_merge2"), f"{label} == skm")

    _, kw = sharded_kwargs(path, 13, 4)
    label = "k=13 classic on 4 shards"
    counter, launches = sharded_run(
        lambda: parallel.ShardedSortCounter(parallel.ShardedSortConfig(**kw), (dev,) * 4),
        path, out("sharded_k13"), label, ("window_keys", "segsum_compact"))
    st = counter.stats
    if launches["window_keys"] != 4 * (st["batches"] + st["replayed_rounds"]):
        raise AssertionError(f"{label}: K3 launched {launches['window_keys']} times")
    total = int(counter.dump()[1].sum())
    if total != files["n_reads"] * (150 - 13 + 1):
        raise AssertionError(f"{label}: sum of counts {total} != valid windows")
    print(f"sharded {label}: sum of counts {total} == valid windows")
    del counter
    same_file(files["k13"], out("sharded_k13"), f"{label} == classic")

    label = f"k={K} probe table on 2 shards"
    counter, launches = sharded_run(
        lambda: parallel.ShardedKmerCounter(parallel.ShardedCounterConfig(
            k=K, min_slots=8_000_000, min_abundance=1), (dev,) * 2),
        path, out("sharded_table2"), label, ("window_keys", "table_insert"))
    st = counter.stats
    if (launches["window_keys"], launches["table_insert"]) != (
            2 * st["batches"], 2 * (st["batches"] + st["grow_events"])):
        raise AssertionError(f"{label}: K3 {launches['window_keys']}, T1 "
                             f"{launches['table_insert']} launches for {st['batches']} batches")
    del counter
    same_counts(files["skm"], out("sharded_table2"), f"{label} == skm")

    # a checkpoint mid-stream on 4 shards, resumed on 2
    chunks = list(io_reader.CodeChunkReader(path))
    half = len(chunks) // 2
    ck = os.path.join(tmp, "sharded.npz")
    _, kw4 = sharded_kwargs(path, K, 4)
    c = parallel.ShardedSkmCounter(parallel.ShardedSkmConfig(**kw4), (dev,) * 4)
    for codes in chunks[:half]:
        c.add_codes(codes)
    c.save(ck)
    del c
    _, kw2 = sharded_kwargs(path, K, 2)
    c = parallel.ShardedSkmCounter.load(ck, parallel.ShardedSkmConfig(**kw2), (dev,) * 2)
    for codes in chunks[half:]:
        c.add_codes(codes)
    c.finish()
    c.write_output(out("sharded_resumed"))
    del c, chunks
    same_file(out("sharded_skm4"), out("sharded_resumed"),
              f"k={K} skm saved on 4 shards after {half} of the input's chunks, resumed on 2, "
              "== the uninterrupted 4-shard run")

    # the CLI asks for one card per shard: --devices 2 on one card exits 1
    res = subprocess.run([sys.executable, "-m", "kaarme_tpu_torch.cli", path, str(K), "-s",
                          "8000000", "-q", "--devices", "2", "-o", out("cli_devices2")],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    have = torch.cuda.device_count()
    if res.returncode != 1 or f"need 2 devices, have {have}" not in res.stderr \
            or os.path.exists(out("cli_devices2")):
        raise AssertionError(f"CLI --devices 2 on {have} card(s): exit {res.returncode}, "
                             f"{res.stderr.strip()!r}")
    print(f"CLI --devices 2 on {have} card: exit 1, {res.stderr.strip()!r}")


# One multi-host worker process: runs with jax and kaarme_tpu refused,
# calls the launcher ("launch": ``multihost.run``) or counts its span in
# two halves with a checkpoint between ("ckpt"), and prints one MHSTATS
# line.  sys.argv: mode, then the launcher's arguments.
MH_WORKER = r"""
import importlib.abc, json, sys, time
T0 = time.perf_counter()
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "kaarme_tpu" \
                or name.startswith("kaarme_tpu."):
            raise ImportError(f"the port imported {name}")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np
import torch
import torch.distributed as dist
from kaarme_tpu_torch.ops import _build, cuda_compact, cuda_merge, cuda_winkeys, writer
from kaarme_tpu_torch.parallel import multihost as mh

mode, argv = sys.argv[1], sys.argv[2:]
_build.lib()
torch.zeros(1, device="cuda")
fns = {"window_keys": cuda_winkeys.window_keys, "segsum_compact": cuda_compact.segsum_compact,
       "merge_compact": cuda_merge.merge_compact, "format_lines": writer.format_lines}
for f in fns.values():
    f.launches = 0
torch.cuda.reset_peak_memory_stats()
start_s = time.perf_counter() - T0
t1 = time.perf_counter()
steps, read_s, save_s, load_s = 0, 0.0, 0.0, 0.0
if mode == "launch":
    rc, c = mh.run(argv)
    if rc:
        sys.exit(rc)
    written = sum(c._nd)
else:
    args = mh.build_parser().parse_args(argv)
    mh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                        args.dist_backend)
    mesh = mh.global_mesh(args.devices, "cuda")
    cfg = lambda: mh.config(args, mesh.nproc * mesh.nloc)
    t = time.perf_counter()
    codes = mh.host_span_codes(args.INPUT, mesh.pid, mesh.nproc, args.KLEN)
    read_s = time.perf_counter() - t
    seps = np.flatnonzero(codes >= 4)          # cut after a separator
    cut = int(seps[len(seps) // 2]) + 1
    first = mh.MultiHostSortCounter(cfg(), mesh)
    first.count_codes(codes[:cut])
    t = time.perf_counter()
    first.save(args.output_file + ".ckpt")
    save_s = time.perf_counter() - t
    steps = first.stats["batches"] + first.stats["replayed_rounds"]
    del first
    t = time.perf_counter()
    c = mh.multihost_load(args.output_file + ".ckpt", cfg(), mesh)
    load_s = time.perf_counter() - t
    c.count_codes(codes[cut:])
    c.finalize_exchange()
    written = c.write_output_part(args.output_file)
    dist.barrier(group=mesh.host_group)
    if mesh.pid == 0:
        mh.merge_parts(args.output_file, mesh.nproc)
    dist.barrier(group=mesh.host_group)
    dist.destroy_process_group()
run_s = time.perf_counter() - t1
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "kaarme_tpu")]
if bad:
    sys.exit(f"the port imported {bad}")
st = c.stats
print("MHSTATS " + json.dumps({
    "pid": c.pid, "nproc": c.nproc, "start_s": start_s, "run_s": run_s,
    "count_s": st["build_seconds"], "exchange_s": st["exchange_seconds"],
    "write_s": st["write_seconds"], "merge_s": st.get("merge_seconds", 0.0),
    "read_s": read_s, "save_s": save_s, "load_s": load_s,
    "peak": torch.cuda.max_memory_allocated(),
    "steps": steps + st["batches"] + st["replayed_rounds"], "rounds": st["batches"],
    "replays": st["replayed_rounds"], "grow_events": st["grow_events"],
    "prefix_cap": c.cfg.prefix_cap, "written": written, "windows": st["windows_processed"],
    "exchange_bytes": st["exchange_bytes"],
    "launches": {name: f.launches for name, f in fns.items()}}), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mh_run(label: str, mode: str, nproc: int, argv, smi: str, timeout: float = 600):
    """Start ``nproc`` multi-host workers (process ids 0..nproc-1) on
    ``argv`` and wait for them; any worker that fails or times out fails
    the phase (every worker is killed first).  Prints one line per
    process and returns their MHSTATS objects, by process id."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER, mode, *argv, "--coordinator", f"localhost:{port}",
         "--num-processes", str(nproc), "--process-id", str(pid)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"multi-host {label}: process {pid} exited {p.returncode}:\n"
                                 f"{so[-2000:]}\n{se[-4000:]}")
    stats = [json.loads(next(ln for ln in so.splitlines() if ln.startswith("MHSTATS "))[8:])
             for so, _ in outs]
    for st in stats:
        print(f"multi-host {label}, process {st['pid']}/{st['nproc']}: start {st['start_s']:.3f} s, "
              f"count {st['count_s']:.3f} s ({st['windows'] / st['count_s']:.0f} windows/s), "
              f"exchange {st['exchange_s']:.3f} s ({st['exchange_bytes']} bytes staged or sent), "
              f"write {st['write_s']:.3f} s, merge {st['merge_s']:.3f} s"
              + (f", span read {st['read_s']:.3f} s, save {st['save_s']:.3f} s, load "
                 f"{st['load_s']:.3f} s (count: the resumed half)" if mode == "ckpt" else "")
              + f", run {st['run_s']:.3f} s "
              f"(pair wall {wall:.3f} s), peak device memory {st['peak']} bytes; rounds "
              f"{st['rounds']} (+{st['replays']} replayed), grow events {st['grow_events']}, "
              f"prefix cap {st['prefix_cap']}, records written {st['written']}; launches "
              f"{st['launches']}; {smi}")
    return stats


def check_mh(label: str, stats, distinct=None):
    """Every process: K3 once per shard step (one local shard), K2 once
    more for the exchange's compaction, K4 never, W1 for its part file;
    one prefix cap and one count of grow events; the parts' records sum
    to ``distinct``."""
    for st in stats:
        want = {"window_keys": st["steps"], "segsum_compact": st["steps"] + 1,
                "merge_compact": 0, "format_lines": max(st["launches"]["format_lines"], 1)}
        if st["launches"] != want:
            raise AssertionError(f"multi-host {label}: process {st['pid']} launches "
                                 f"{st['launches']} != {want}")
    if len({(st["prefix_cap"], st["grow_events"]) for st in stats}) != 1:
        raise AssertionError(f"multi-host {label}: processes disagree on growth: "
                             f"{[(st['prefix_cap'], st['grow_events']) for st in stats]}")
    total = sum(st["written"] for st in stats)
    if distinct is not None and total != distinct:
        raise AssertionError(f"multi-host {label}: parts hold {total} records, not {distinct}")
    print(f"multi-host {label}: K3 launched once per shard step "
          f"({[st['steps'] for st in stats]}), K2 once more, W1 "
          f"{[st['launches']['format_lines'] for st in stats]} times; prefix cap "
          f"{stats[0]['prefix_cap']} and {stats[0]['grow_events']} grow events on every "
          f"process; parts {[st['written'] for st in stats]} records")


def phase_multihost(files: dict, smi: str):
    """Phase 10: multi-host counting on the full-size file, real processes
    on cuda:0 (docstring item 10)."""
    import numpy as np

    path, tmp = files["input"], os.path.dirname(files["input"])
    out = lambda name: os.path.join(tmp, name + ".txt")
    k51 = [path, str(K), "-s", "8000000", "-a", "1", "--batch-log2", "22", "--devices", "1"]
    gloo = ["--dist-backend", "gloo", "--merge-parts"]

    stats = mh_run(f"k={K}, 2 processes on gloo", "launch", 2,
                   k51 + gloo + ["-o", out("mh_k51")], smi)
    check_mh(f"k={K}, 2 processes on gloo", stats, DISTINCT_K51)
    same_file(files["skm"], out("mh_k51"), f"k={K} multi-host, 2 processes on gloo == skm")

    stats = mh_run(f"k={K}, world size 1 on NCCL", "launch", 1,
                   k51 + ["--merge-parts", "-o", out("mh_nccl")], smi)
    check_mh(f"k={K}, world size 1 on NCCL", stats, DISTINCT_K51)
    same_file(files["skm"], out("mh_nccl"), f"k={K} multi-host, world size 1 on NCCL == skm")

    argv = [path, "13", "-s", "8000000", "-a", "1", "--batch-log2", "22", "--devices", "1"]
    stats = mh_run("k=13, 2 processes on gloo", "launch", 2,
                   argv + gloo + ["-o", out("mh_k13")], smi)
    check_mh("k=13, 2 processes on gloo", stats)
    with open(out("mh_k13"), "rb") as f:
        total = int(np.array(f.read().split()[1::2], dtype=np.int64).sum())
    if total != files["n_reads"] * (150 - 13 + 1):
        raise AssertionError(f"multi-host k=13: sum of counts {total} != valid windows")
    print(f"multi-host k=13: sum of counts {total} == valid windows")
    same_file(files["k13"], out("mh_k13"), "k=13 multi-host, 2 processes on gloo == classic")

    stats = mh_run(f"k={K}, checkpoint halfway, 2 processes on gloo", "ckpt", 2,
                   k51 + ["--dist-backend", "gloo", "-o", out("mh_ckpt")], smi)
    check_mh(f"k={K}, checkpoint halfway", stats, DISTINCT_K51)
    same_file(out("mh_k51"), out("mh_ckpt"),
              f"k={K} multi-host saved halfway through each span and resumed == uninterrupted")

    # 3 processes x 1 device: refused from the arguments, before connecting
    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-m", "kaarme_tpu_torch.parallel.multihost", *k51, "--coordinator",
         f"localhost:{free_port()}", "--num-processes", "3", "--process-id", "0",
         "-o", out("mh_three")], capture_output=True, text=True, timeout=120, cwd=root)
    msg = "device count must be a power of two, got 3 (3 processes x 1 devices)"
    if res.returncode != 1 or msg not in res.stderr or os.path.exists(out("mh_three") + ".part0"):
        raise AssertionError(f"multi-host --num-processes 3: exit {res.returncode}, "
                             f"{res.stderr.strip()!r}")
    print(f"multi-host --num-processes 3 --devices 1: exit 1, {res.stderr.strip()!r}")


def w1_rows(dev, k: int, n: int, counts: str, layout: str = "store", seed: int = 0):
    """A dump part at full size, on the card: n sorted rows of random
    canonical-width keys (the trailing word's unused low bits 0) and int32
    counts ("reads": mostly 1-59 with one row in 1000 up to 70,000, as a
    30x run gives; "wrap": uniform 0-70,000, with every 997th row 65,536
    (written as 0 under -m 0 -a 0) and the next one dead).  Layout
    "store": the key columns are rows of one (W + 1, n) buffer, as a sort
    store's; "table": the rows are scattered over a 2^23-slot (C, W) slot
    array whose other slots are empty (count 0), as the table's dump part."""
    import torch
    from kaarme_tpu_torch.ops import sortcount

    g = torch.Generator(device=dev).manual_seed(SEED + seed)
    W = (k + 15) // 16
    keys = torch.randint(-(1 << 31), 1 << 31, (W, n), generator=g, device=dev,
                         dtype=torch.int32)
    tail = 2 * (k - 16 * (W - 1))
    if tail < 32:
        keys[W - 1] &= -(1 << (32 - tail))
    if counts == "wrap":
        cnt = torch.randint(0, 70_001, (n,), generator=g, device=dev, dtype=torch.int32)
        cnt[::997] = 65_536
        cnt[1::997] = 0
    else:
        cnt = torch.randint(1, 60, (n,), generator=g, device=dev, dtype=torch.int32)
        big = torch.rand(n, generator=g, device=dev) < 1e-3
        cnt[big] = torch.randint(1, 70_001, (int(big.sum()),), generator=g, device=dev,
                                 dtype=torch.int32)
    rows = sortcount.lexsort(list(keys) + [cnt], num_keys=W)
    del keys, cnt
    if layout == "store":
        return tuple(rows[:W].unbind(0)), rows[W]
    C = 1 << 23
    slots = torch.randperm(C, generator=g, device=dev)[:n]
    tk = torch.full((C, W), -1, dtype=torch.int32, device=dev)
    cn = torch.zeros(C, dtype=torch.int32, device=dev)
    tk[slots] = rows[:W].T
    cn[slots] = rows[W]
    return tuple(tk.unbind(1)), cn


def w1_bound(keys, cnt, text, k: int) -> dict:
    """W1's least time: every count and the key words of the live rows
    read once and the text written once, against about 10 operations a
    row, 3 a base and 3 a digit of every line written."""
    live = int((cnt > 0).sum())
    nbytes = 4 * len(keys) * live + cnt.numel() * cnt.element_size() + text.numel()
    lines = int((text == ord("\n")).sum())
    digits = text.numel() - lines * (k + 2)
    ops = 10.0 * cnt.numel() + 3.0 * (k * lines + digits)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", bound_bytes=nbytes, bound_ops=ops)


def phase_w1(dev):
    """W1 (the count file's lines) against its plain version, byte for
    byte, on random sorted rows at full size (docstring item 11)."""
    import torch
    from kaarme_tpu_torch.ops import writer

    host = torch.empty(writer.CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)

    def d2h_ms(text) -> float:
        return cuda_ms(lambda: host[:text.numel()].copy_(text, non_blocking=True), 3)

    out, err = {}, 0
    cases = ((f"k={K}", K, DISTINCT_K51, "reads", "store", 1),
             ("k=13 table layout", 13, 4_297_645, "reads", "table", 1),
             ("k=201", 201, 1 << 20, "reads", "store", 2),
             (f"k={K} -m 0 -a 0", K, DISTINCT_K51, "wrap", "store", 0))
    for label, k, n, counts, layout, abu in cases:
        keys, cnt = w1_rows(dev, k, n, counts, layout, seed=k)
        mode = 0 if counts == "wrap" else 2
        kw = dict(k=k, mode=mode, min_abundance=abu)
        buf = torch.empty(cnt.numel() * writer.line_bytes(k), dtype=torch.uint8, device=dev)
        text, lines = writer.format_lines(keys, cnt, out=buf, **kw)
        want, want_lines = writer.format_lines_plain(keys, cnt, **kw)
        torch.cuda.synchronize()
        if lines != want_lines or text.numel() != want.numel():
            raise AssertionError(f"W1 {label}: kernel {text.numel()} bytes / {lines} lines != "
                                 f"plain {want.numel()} / {want_lines}")
        e = int((text.to(torch.int16) - want.to(torch.int16)).abs().max())
        if e:
            raise AssertionError(f"W1 {label}: kernel != plain (max abs err {e})")
        err = max(err, e)
        del want
        ms = cuda_ms(lambda: writer.format_lines(keys, cnt, out=buf, **kw))
        plain_ms = cuda_ms(lambda: writer.format_lines_plain(keys, cnt, **kw), 3)
        b = w1_bound(keys, cnt, text, k)
        copy_ms = d2h_ms(text)
        out[label] = dict(ms=ms, plain_ms=plain_ms, d2h_ms=copy_ms, **b)
        print(f"W1 format_lines {label} ({layout} layout, {cnt.numel()} rows, "
              f"{cnt.dtype}): {lines} lines, {text.numel()} bytes == plain; kernel {ms:.3f} "
              f"ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
              f"{b['bound_bytes']} B), device-to-host copy into pinned memory {copy_ms:.3f} ms")
        del keys, cnt, buf, text
        torch.cuda.empty_cache()

    # 2^26 rows, ~3.7 GB of text: write_lines' row chunks, each held to the
    # plain version, so that more than 2^31 bytes pass through the chunking
    n = 1 << 26
    keys, cnt = w1_rows(dev, K, n, "reads", seed=3)
    rows = writer.CHUNK_BYTES // writer.line_bytes(K)
    buf = torch.empty(rows * writer.line_bytes(K), dtype=torch.uint8, device=dev)
    total, lines, chunks, digest = 0, 0, [], 0
    for r0 in range(0, n, rows):
        part = ([c[r0:r0 + rows] for c in keys], cnt[r0:r0 + rows])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        text, m = writer.format_lines(*part, out=buf, k=K, mode=2, min_abundance=1)
        b.record()
        want, want_m = writer.format_lines_plain(*part, k=K, mode=2, min_abundance=1)
        if m != want_m or text.numel() != want.numel() or not torch.equal(text, want):
            raise AssertionError(f"W1 2^26 rows: chunk at row {r0} differs from plain")
        sums = [int(t.sum(dtype=torch.int64)) for t in (text, want)]
        if sums[0] != sums[1]:
            raise AssertionError(f"W1 2^26 rows: chunk at row {r0}: digests {sums}")
        digest = (digest * 1_000_003 + sums[0]) % (1 << 61)
        del want
        chunks.append((a.elapsed_time(b), d2h_ms(text)))
        total += text.numel()
        lines += m
    if total <= 1 << 31 or lines != n:
        raise AssertionError(f"W1 2^26 rows: {total} bytes, {lines} lines")
    print(f"W1 format_lines k={K}, 2^26 rows in {len(chunks)} chunks of {rows} rows: {lines} "
          f"lines, {total} bytes (> 2^31), every chunk == plain (digest {digest}); per chunk "
          f"kernel ms {[round(c[0], 3) for c in chunks]}, device-to-host ms "
          f"{[round(c[1], 3) for c in chunks]}")
    del keys, cnt, buf, host
    torch.cuda.empty_cache()
    main = out[f"k={K}"]
    extra = {f"{key}_{f}": out[label][f] for label, key in (
        ("k=13 table layout", "k13"), ("k=201", "k201"), (f"k={K} -m 0 -a 0", "wrap"))
        for f in ("ms", "plain_ms", "bound_ms")}
    return dict(max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"], d2h_ms=main["d2h_ms"],
                big_chunks=len(chunks), big_bytes=total, **extra,
                **{key: main[key] for key in ("bound_ms", "bound_by", "bound_bytes",
                                              "bound_ops")})


E1_CASES = ((K, 1 << 20), (201, 1 << 20), (300, 4099), (16, 777))   # (k, runs); timed: 2^20


def e1_runs(dev, k: int, R: int, seed: int):
    """R run rows at k as a run store holds them, one buffer: random
    content words, ell uniform in 1..16, counts 1..5 but every 20th run
    dead (count 0), every 7th at 2^20 + 1.  Returns the Wc + 2 columns."""
    import torch
    from kaarme_tpu_torch.ops import skm

    g = torch.Generator(device=dev).manual_seed(seed)
    wc = skm.content_words(k)
    buf = torch.empty((wc + 2, R), dtype=torch.int32, device=dev)
    buf[:wc] = torch.randint(-(1 << 31), 1 << 31, (wc, R), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
    buf[wc] = torch.randint(0, 16, (R,), generator=g, device=dev, dtype=torch.int32) << skm.EBITS
    buf[wc + 1] = torch.randint(1, 6, (R,), generator=g, device=dev, dtype=torch.int32)
    buf[wc + 1, ::7] = (1 << 20) + 1
    buf[wc + 1, ::20] = 0
    return tuple(buf.unbind(0))


def phase_e1(dev):
    """Phase 13: E1 (the skm finalize's expansion) against its plain
    version, bit for bit on every column, at the finalize's chunk (2^20
    runs, k=51), at k=201 (W = 13), at k=300 (W = 19) and k=16 on tails
    of no whole block; the 2^20-run cases timed beside the plain chain
    and the bound (the runs read once, the rows written once); one launch
    a call."""
    import torch
    from kaarme_tpu_torch.ops import cuda_expand, skm

    res = {}
    for k, R in E1_CASES:
        cols = e1_runs(dev, k, R, SEED + k)
        cuda_expand.expand_runs.launches = 0
        got = cuda_expand.expand_runs(cols, k)
        want = skm.expand_runs_plain(cols, k)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err or cuda_expand.expand_runs.launches != 1:
            raise AssertionError(f"E1 k={k} R={R}: kernel != plain (max abs err {err}), "
                                 f"{cuda_expand.expand_runs.launches} launches")
        del want
        if R < 1 << 20:
            print(f"E1 expand_runs k={k}: {R} runs -> {R * skm.LMAX} rows == plain")
            continue
        W = len(got) - 1
        ms = cuda_ms(lambda: cuda_expand.expand_runs(cols, k))
        plain_ms = cuda_ms(lambda: skm.expand_runs_plain(cols, k), reps=3)
        # per row and key word: two funnel shifts, the pair reversal, compare, select
        b = bound(cols, got, 24.0 * W * R * skm.LMAX)
        print(f"E1 expand_runs k={k}: {R} runs -> {R * skm.LMAX} rows x {W}+1 cols == plain; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), share {b['bound_ms'] / ms:.3f}")
        res[k] = dict(ms=ms, plain_ms=plain_ms, **b)
        del got, cols
        torch.cuda.empty_cache()
    out = dict(res[K], max_abs_err=0)
    out.update({f"k201_{key}": v for key, v in res[201].items()})
    return out


def reads_fasta_bytes(n_reads: int, genome_len: int = 4_600_000, read_len: int = 150,
                      seed: int = SEED, crlf_wrap: int = 0) -> bytes:
    """FASTA of ``n_reads`` reads of a random genome as the benchmark lays
    them out (``>r`` and the index, the bases on one line); with
    ``crlf_wrap`` the bases wrap every that many and lines end in CRLF."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - read_len, n_reads)
    seq = np.frombuffer(b"ACGT", np.uint8)[genome[starts[:, None] + np.arange(read_len)]]
    if not crlf_wrap:
        return b"".join(b">r%d\n%s\n" % (i, seq[i].tobytes()) for i in range(n_reads))
    out = []
    for i in range(n_reads):
        r = seq[i].tobytes()
        out.append(b">r%d\r\n" % i + b"".join(r[j:j + crlf_wrap] + b"\r\n"
                                              for j in range(0, read_len, crlf_wrap)))
    return b"".join(out)


def p1_stream(dev, data: bytes, block: int, kernels: str, k: int = K, sb: int = N_WINDOWS):
    """The device code stream's chunks of ``data`` fed in ``block``-byte blocks."""
    import torch
    from kaarme_tpu_torch.io import rawstream

    st = rawstream.CodeStream(dev, k, sb, kernels)
    got = []
    for pos in range(0, len(data), block):
        got += st.feed(torch.frombuffer(bytearray(data[pos:pos + block]), dtype=torch.uint8)
                       .pin_memory(), True)
    return got + st.close()


def phase_p1(dev):
    """Phase 14: P1 through the device code stream against the host's
    encode + pack (147 MB, 8 MiB blocks) and against its plain version
    (CRLF, wrapped lines, 4 KiB blocks); one 8 MiB block timed with its
    bound."""
    import numpy as np
    import torch
    from kaarme_tpu_torch.io import fastio
    from kaarme_tpu_torch.ops import cuda_parse

    data = reads_fasta_bytes(920_000)
    codes = fastio.encode_fasta(data)[0]
    cuda_parse.parse_pack.launches = 0
    got = p1_stream(dev, data, 8 << 20, "cuda")
    torch.cuda.synchronize()
    launches = cuda_parse.parse_pack.launches
    if launches != -(-len(data) // (8 << 20)):
        raise AssertionError(f"P1: {launches} launches for {len(data)} bytes")
    for s, (words, bits, n) in enumerate(got):
        pw, pm = fastio.pack_stream(codes[s * N_WINDOWS: s * N_WINDOWS + n + K - 1])
        if not (np.array_equal(words.cpu().numpy().view(np.uint32), pw)
                and np.array_equal(bits.cpu().numpy().view(np.uint32), pm)):
            raise AssertionError(f"P1: superstep {s} != the host's encode + pack")
    full = (codes.shape[0] - K + 1) // N_WINDOWS
    if len(got) != full + (codes.shape[0] - full * N_WINDOWS >= K):
        raise AssertionError(f"P1: {len(got)} supersteps for {codes.shape[0]} codes")
    print(f"P1 parse_pack: {len(data)} bytes in {launches} blocks -> {codes.shape[0]} codes, "
          f"{len(got)} supersteps == host encode + pack")
    del got
    small = reads_fasta_bytes(20_000, crlf_wrap=70)
    a = p1_stream(dev, small, 4096, "cuda", sb=1 << 16)
    b = p1_stream(dev, small, 4096, "plain", sb=1 << 16)
    torch.cuda.synchronize()
    if len(a) != len(b) or any(x[2] != y[2] or max_abs_err(x[:2], y[:2]) for x, y in zip(a, b)):
        raise AssertionError("P1: CRLF, wrapped lines, 4 KiB blocks: kernel != plain")
    print(f"P1 parse_pack: CRLF + wrapped lines, {len(small)} bytes in 4 KiB blocks == plain")

    # one 8 MiB block into a fresh stream: words and bitmap of superstep 0
    blk = data[:8 << 20]
    raw = torch.frombuffer(bytearray(blk), dtype=torch.uint8).to(dev)
    span = N_WINDOWS + K - 1

    def prepare():
        chunks = [(torch.zeros(-(-span // 16), dtype=torch.int32, device=dev),
                   torch.zeros(-(-span // 32), dtype=torch.int32, device=dev))]
        return (cuda_parse.ParseState(dev), chunks)

    def run(state, chunks, kernels="cuda"):
        cuda_parse.parse_pack(raw, fasta=True, state=state, chunks=chunks, base=0,
                              sb=N_WINDOWS, span=span, kernels=kernels)

    ms = cuda_ms_fresh(prepare, run)
    dev_ms = cuda_ms_queued(prepare, run)
    plain_ms = cuda_ms_fresh(prepare, lambda st, ch: run(st, ch, "plain"), reps=3)
    t0 = time.perf_counter()
    for _ in range(3):
        host = fastio.pack_stream(fastio.encode_fasta(blk)[0])
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    st, ch = prepare()
    run(st, ch)
    n = int(st.buf[2])
    words, bits = ch[0][0][:-(-n // 16)], ch[0][1][:-(-n // 32)]
    if not (np.array_equal(words.cpu().numpy().view(np.uint32), host[0])
            and np.array_equal(bits.cpu().numpy().view(np.uint32), host[1])):
        raise AssertionError("P1: the timed block != the host's encode + pack")
    # bytes: the block read once, its codes' words and bitmap written once
    # (no operation count sets it: a few dozen integer operations a byte)
    b_ = bound([raw], [words, bits], 40.0 * len(blk))
    print(f"P1 parse_pack: one {len(blk)}-byte block -> {n} codes: the call {ms:.3f} ms, "
          f"card {dev_ms:.4f} ms, plain {plain_ms:.3f} ms, host encode + pack "
          f"{host_ms:.3f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}), card share "
          f"{b_['bound_ms'] / dev_ms:.3f}")
    return dict(ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, host_ms=host_ms, max_abs_err=0,
                launches_per_job=launches, **b_)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "kaarme_tpu_torch", "csrc")):
        print("error: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from kaarme_tpu_torch.ops import _build

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi)
    nvcc = [ln for ln in sh([_build.find_nvcc(), "--version"]).splitlines() if "release" in ln]
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc: {nvcc[0].strip() if nvcc else 'unknown'}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel library {_build.BUILD_INFO['path']}: ready in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {_build.BUILD_INFO['seconds']} s; "
          "None = already built)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    k1, k1_out = phase_k1(dev)
    k2 = phase_k2(dev, k1_out)
    del k1_out
    torch.cuda.empty_cache()
    k3, batches = phase_k3(dev)
    k4, k2_classic = phase_k4(dev, batches)
    k2.update(k2_classic)
    del batches
    torch.cuda.empty_cache()
    k5 = phase_k5(dev)
    torch.cuda.empty_cache()
    t1 = phase_t1(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_small(tmp)
        launches, files = phase_full(tmp)
        torch.cuda.empty_cache()
        phase_sharded(files)
        torch.cuda.empty_cache()
        phase_multihost(files, smi)
    torch.cuda.empty_cache()
    w1 = phase_w1(dev)
    torch.cuda.empty_cache()
    b1, b2 = phase_bloom(dev)
    torch.cuda.empty_cache()
    e1 = phase_e1(dev)
    torch.cuda.empty_cache()
    p1 = phase_p1(dev)
    leaked = [m for m in sys.modules if m in ("jax", "kaarme_tpu") or m.startswith("kaarme_tpu.")]
    if leaked:
        raise AssertionError(f"the port imported {leaked}")

    table = {"kernels": [
        dict(name="skm_dense", route="cuda", source="kaarme_tpu_torch/csrc/skm_dense.cu",
             replaces="kaarme_tpu/ops/pallas_skm.py:564", launches=launches["skm_dense"],
             **timed(k1)),
        dict(name="segsum_compact", route="cuda",
             source="kaarme_tpu_torch/csrc/segsum_compact.cu",
             replaces="kaarme_tpu/ops/pallas_compact.py:520",
             launches=launches["segsum_compact"], **timed(k2)),
        dict(name="window_keys", route="cuda", source="kaarme_tpu_torch/csrc/winkeys.cu",
             replaces="kaarme_tpu/ops/pallas_winkeys.py:136",
             launches=launches["window_keys"], **timed(k3)),
        dict(name="merge_compact", route="cuda",
             source="kaarme_tpu_torch/csrc/merge_compact.cu",
             replaces="kaarme_tpu/ops/pallas_merge.py:363",
             launches=launches["merge_compact"], **timed(k4)),
        dict(name="skm_slotted", route="cuda", source="kaarme_tpu_torch/csrc/skm_slotted.cu",
             replaces="kaarme_tpu/ops/pallas_skm.py:378", launches=launches["skm_slotted"],
             **timed(k5)),
        dict(name="table_insert", route="cuda", source="kaarme_tpu_torch/csrc/table_insert.cu",
             replaces="kaarme_tpu/ops/table.py:57", launches=launches["table_insert"],
             **timed(t1)),
        dict(name="format_lines", route="cuda", source="kaarme_tpu_torch/csrc/format_lines.cu",
             replaces="kaarme_tpu/models/sort_counter.py:495",
             launches=launches["format_lines"], **timed(w1)),
        dict(name="bloom_insert", route="cuda", source="kaarme_tpu_torch/csrc/bloom.cu",
             replaces="kaarme_tpu/ops/bloom.py:141", launches=launches["bloom_insert"],
             **timed(b1)),
        dict(name="bloom_gate", route="cuda", source="kaarme_tpu_torch/csrc/bloom.cu",
             replaces="kaarme_tpu/ops/sortcount.py:771", launches=launches["bloom_gate"],
             **timed(b2)),
        dict(name="expand_runs", route="cuda", source="kaarme_tpu_torch/csrc/expand_runs.cu",
             replaces="kaarme_tpu/ops/skm.py:432", launches=launches["expand_runs"],
             **timed(e1)),
        dict(name="parse_pack", route="cuda", source="kaarme_tpu_torch/csrc/parse_pack.cu",
             replaces="kaarme_tpu/io/fastio.py:81 encode_fasta + :131 pack_stream (host)",
             launches=launches["parse_pack"], **timed(p1)),
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
