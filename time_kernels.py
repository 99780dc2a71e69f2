#!/usr/bin/env python3
"""Time one kernel of two checkouts on one card, in turns, on chip_smoke's inputs.

    python3 time_kernels.py --kernel k1|k2|k3|k4|k5|t1|bloom|table|w1|bloom_e2e|e1|p1 OTHER_ROOT \
        [--reps 5]

Run from the repository root.  Times a kernel of this checkout and of the
checkout at OTHER_ROOT (for example the parent commit, unpacked with
``git archive``) on the inputs chip_smoke.py builds (``read_stream`` +
``chunk_of``: k=51, 2^26 windows of 150 bp reads sampled from a random
4.6 Mb genome, with N patches, separators as a sparse list):

- k1: ``cuda_skm.run_rows_dense`` at cap 2^23 (the skm counter's first
  capacity);
- k2: ``cuda_compact.segsum_compact`` at chip_smoke's three shapes: the
  run-store merge (embedded, 6 columns), the finalize (full_sum, 4 + 1)
  and the classic k=13 superstep (full_sum, 1 + 1), whose inputs come
  from the plain versions;
- k3: ``cuda_winkeys.window_keys`` at k=51 and k=13 (the classic
  path's superstep);
- k4: ``cuda_merge.merge_compact`` at chip_smoke's two shapes: the store
  after one superstep (2^23 rows) merged with the next superstep's sorted
  window keys, k=51 embedded and k=13 separate count, whose inputs come
  from the plain versions;
- k5: ``cuda_skm.run_rows_slotted`` at S=96;
- t1: the table route's step from K3's key columns to the updated table,
  on chip_smoke's phase-T1 batches: one 2^20-window batch of k=51 reads
  into a 2^23-slot table holding the 63 batches before it, a poly-A
  batch and an AC-repeat batch into an empty one, each timed from a
  fresh copy of its table.  Where a checkout's ``table_insert`` needs
  ``valid`` and ``h`` (before T1 derived them), the timed call is the
  chain it ran: the sentinel mask, ``hashing.hash_words``, then T1; the
  digest is the sorted occupied (key row, count) pairs;
- bloom: the -b path's steps from K3's key columns at the CLI's ``-b -u
  5000000`` filter size (2^28 bits a stage, 7 hash functions): the
  table's pass-1 insert into both stages and its pass-2 gate against
  BF2, on one 2^20-window batch of k=51 reads after the 63 batches before
  it, a poly-A batch after one poly-A batch, a k=13 batch after 7
  batches, and two 2^26-window sort supersteps of k=51 reads (a sort
  route's pass 1: ``superstep0`` on empty filters, ``superstep1`` on the
  filters after it), each timed from fresh copies of its filters (the
  insert) or of its key columns (the gate).  A checkout with
  ``ops/cuda_bloom.py`` runs B1 and B2; one without it runs the torch
  chain it ran before them (the sentinel mask, ``hash_words64`` and
  ``bloom.insert_batch``; the gate ``_bloom_miss_mask`` ORed into the
  keys); the digest is the filters and counters after the insert and the
  gated keys.  Beside each step's CUDA-event median of the call, ``ms``
  holds as ``<step>_dev`` the card's time (``chip_smoke.cuda_ms_queued``:
  the launches queued behind a sleep kernel), as ``<step>_host`` the
  host's time from the call to its return (the wrapper's Python and its
  launches), and ``kernels`` the profiler's device milliseconds of each
  kernel and memset of a call;
- bloom_e2e: not one kernel but the ``-b`` routes end to end: the CLI's
  ``-b -u 5000000 -a 2`` runs at k=51 of the same FASTA as ``table``
  (below) on the skm, classic and table routes; ``ms`` holds the median
  wall, pass-1, count (``build_seconds``) and write milliseconds of each,
  ``runs`` every run's (the first warms up) with its ``cudaMalloc``
  calls, ``peak_bytes`` its peak device memory, the digest the SHA-256
  of the sorted count file;
- table: not one kernel but the probe-table route around T1: a
  ``KmerCounter`` (k=51, ``min_slots`` 8,000,000, the CLI's table
  configuration) counting chip_smoke's full-size FASTA (4.6 Mb genome,
  150 bp reads at 30x, written once and shared by the four processes);
  ``ms`` holds the median milliseconds of ``count_file`` (wall) and of
  ``stats["build_seconds"]`` (the whole ``count_file``; the device steps
  alone in a checkout from before the tracer), the digest is the sorted
  dump's;
- w1: not one kernel but the count file's write step, from the counted
  store to the closed file, on the same FASTA: the k=51 skm route's
  finalized store and the k=13 classic route's store (each counted once
  per process by the CLI at ``-s 8000000 -a 1``, which also warms the
  write up).  A checkout with ``ops/writer.py`` times ``write_lines`` on
  its ``dump_columns()`` (W1 on the card, the text through one pinned
  buffer); one without it times the host path it ran before W1:
  ``live_rows_to_host`` + ``_format_lines``, kept below as private
  copies.  ``ms`` holds the median host milliseconds of the step, the
  digest is the file's SHA-256;
- e1: the skm finalize's expansion of one chunk of run rows,
  ``skm.expand_chunk(cols, k)`` (E1 where the checkout has
  ``ops/cuda_expand.py``, the plain PyTorch chain where it has not) and
  ``skm.expand_chunk(cols, k, kernels="plain")`` (the plain chain in
  both), on 2^20 synthetic run rows at k=51 (the finalize's chunk) and
  k=201, made on the card from a fixed seed as one buffer (a run
  store's layout): random content words, ell uniform in 1 .. 16, counts
  1 .. 5 with every 20th run dead.  Beside each call's CUDA-event
  median, ``ms`` holds ``<name>_dev``, the card's time (the profiler's
  sum over the call's kernels, copies and memsets), ``launches`` the
  device operations of a call and ``ops`` the aten ops it dispatches;
  ``bound_ms`` is the bytes once (the rows written, the runs read) at
  3.35 TB/s;
- p1: one 8 MiB block of FASTA (``chip_smoke.reads_fasta_bytes``: 150 bp
  reads, the benchmark's layout) to its transfer chunk, the 2-bit words
  and the dense bitmap of its codes: P1 (``cuda_parse.parse_pack``) where
  the checkout has ``ops/cuda_parse.py``, timed from fresh zeroed chunks
  (``block``: the call; ``block_dev``: the card's time queued behind a
  sleep kernel), and where it has not, the host path it ran: the
  encode, the pack and the copy of both arrays to the card (``block``:
  the host's time to the copies' end); the digest is the words and the
  bitmap; ``bound_ms`` is the block read once and the words and bitmap
  written once at 3.35 TB/s.

Where a checkout's K1, K3 or K5 takes codes (before its chunk-input
kernel), the timed call is ``sortcount.codes_from_chunk`` followed by it,
as its main path ran them (``inspect`` tells them apart, as it tells
the T1 interfaces apart).  Each checkout runs in its own process (the packages
share a name), in the order other, this, this, other; each process builds
its kernels first and prints one JSON line: CUDA-event medians of
``--reps`` calls after a warm-up, and a digest of the outputs, which must
agree.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CAP = 1 << 23
S_SLOTS = 96


def chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(tensors) -> int:
    return sum(int((t.long() * (i + 1)).sum()) for i, t in enumerate(tensors))


def takes_codes(fn) -> bool:
    return next(iter(inspect.signature(fn).parameters)) == "codes"


def k1_calls(cs, dev):
    from kaarme_tpu_torch.ops import cuda_skm, sortcount

    k, n = cs.K, cs.N_WINDOWS
    packed, sep, _ = cs.chunk_of(cs.read_stream(dev, 4_600_000, n + k - 1, n_every=100_003))
    if takes_codes(cuda_skm.run_rows_dense):
        def fn():
            codes = sortcount.codes_from_chunk(packed, sep, k=k, n=n, dense=False)
            return cuda_skm.run_rows_dense(codes, k=k, n=n, cap=CAP)
        return "codes_from_chunk + K1 (codes input)", {"k1": fn}
    return "K1 (chunk input)", {
        "k1": lambda: cuda_skm.run_rows_dense(packed, sep, k=k, n=n, cap=CAP, dense=False)}


def k5_calls(cs, dev):
    from kaarme_tpu_torch.ops import cuda_skm, sortcount

    k, n = cs.K, cs.N_WINDOWS
    packed, sep, _ = cs.chunk_of(cs.read_stream(dev, 4_600_000, n + k - 1, n_every=100_003))
    if takes_codes(cuda_skm.run_rows_slotted):
        def fn():
            codes = sortcount.codes_from_chunk(packed, sep, k=k, n=n, dense=False)
            return cuda_skm.run_rows_slotted(codes, k=k, n=n, S=S_SLOTS)
        return "codes_from_chunk + K5 (codes input)", {"k5": fn}
    return "K5 (chunk input)", {
        "k5": lambda: cuda_skm.run_rows_slotted(packed, sep, k=k, n=n, S=S_SLOTS, dense=False)}


def k3_calls(cs, dev):
    import torch
    from kaarme_tpu_torch.ops import cuda_winkeys, sortcount

    n, calls = cs.N_WINDOWS, {}
    codes_input = takes_codes(cuda_winkeys.window_keys)
    for k in (51, 13):
        packed, sep, _ = cs.chunk_of(cs.read_stream(dev, 4_600_000, n + k - 1, n_every=100_003))

        def fn(packed=packed, sep=sep, k=k):
            if codes_input:
                codes = sortcount.codes_from_chunk(packed, sep, k=k, n=n, dense=False)
                keys = cuda_winkeys.window_keys(codes, k, n)
            else:
                keys = cuda_winkeys.window_keys(packed, sep, k=k, n=n, dense=False)
            return keys, torch.tensor([len(keys)])
        calls[f"k{k}"] = fn
    return ("codes_from_chunk + K3 (codes input)" if codes_input else "K3 (chunk input)"), calls


def k4_calls(cs, dev):
    """K4 at chip_smoke's two shapes; the inputs come from the plain
    versions (the window keys from codes, sort, the plain K2), so both
    checkouts time the same rows."""
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, cuda_merge, cuda_winkeys

    n, calls = cs.N_WINDOWS, {}
    for k in (51, 13):
        codes = cs.read_stream(dev, 4_600_000, 2 * n + k - 1, n_every=100_003)
        first = cuda_winkeys.window_keys_torch(codes[:n + k - 1], k, n)
        nxt = cuda_winkeys.window_keys_torch(codes[n:], k, n)
        del codes
        a, b, emb, eb, _ = cs.k4_runs(first, nxt, k, cuda_compact.segsum_compact_torch, CAP)
        del first, nxt
        torch.cuda.empty_cache()
        calls[f"k{k}_{'embedded' if emb else 'separate'}"] = (
            lambda a=a, b=b, emb=emb, eb=eb: cuda_merge.merge_compact(
                a, b, embedded=emb, ebits=eb, out_len=CAP))
    return "K4", calls


def k2_calls(cs, dev):
    """K2 at chip_smoke's three timed shapes; the inputs come from the
    plain versions, so both checkouts time the same rows."""
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, cuda_skm, cuda_winkeys, skm, sortcount

    k, n = cs.K, cs.N_WINDOWS
    packed, sep, _ = cs.chunk_of(cs.read_stream(dev, 4_600_000, n + k - 1, n_every=100_003))
    cols, rows = cuda_skm.run_rows_dense_plain(packed, sep, k=k, n=n,
                                               cap=sortcount.next_store_size(n // 8))
    merge, n1 = cs.k2_merge_input(cols, int(rows[0]))
    del cols, packed, sep
    store = cuda_compact.segsum_compact_torch(merge, None, ebits=skm.EBITS)
    fkeys, fcnt = cs.k2_finalize_input(store, n1)
    del store
    codes = cs.read_stream(dev, 4_600_000, 2 * n + 12, n_every=100_003)
    first = cuda_winkeys.window_keys_torch(codes[:n + 12], 13, n)
    nxt0 = cuda_winkeys.window_keys_torch(codes[n:], 13, n)[0]
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    s1 = sortcount.lexsort(list(first) + [ones], num_keys=1)
    pk, pc, _ = cuda_compact.segsum_compact_torch(s1[:1], s1[1].contiguous(), out_len=CAP)
    ckeys, ccnt = cs.k2_classic_input(pk, pc, nxt0)
    del codes, first, s1, pk, pc, nxt0
    torch.cuda.empty_cache()
    return "K2", {
        "merge_embedded": lambda: cuda_compact.segsum_compact(merge, None, ebits=skm.EBITS),
        "finalize_full_sum": lambda: cuda_compact.segsum_compact(fkeys, fcnt),
        "classic_k13_full_sum": lambda: cuda_compact.segsum_compact(ckeys, ccnt, out_len=CAP)}


def t1_worker(cs, dev, root: str, reps: int) -> dict:
    """The step from K3's key columns to the updated table (``t1``
    above), CUDA-event medians from fresh copies of each table."""
    import torch
    from kaarme_tpu_torch.ops import cuda_table, hashing, sortcount

    per = cs.TABLE_TILE * cs.TABLE_BATCH_TILES
    fused = inspect.signature(cuda_table.table_insert).parameters["valid"].default is None

    def step(tk, cn, keys):
        if fused:
            return cuda_table.table_insert(tk, cn, keys)
        valid = sortcount._is_sentinel_i32(keys) == 0
        return cuda_table.table_insert(tk, cn, keys, valid, hashing.hash_words(keys))

    out = dict(root=root, api="T1 from the key columns" if fused else
               "sentinel mask + hash_words + T1", ms={}, digest={})
    for name, before in (("k51", 63), ("polyA", 0), ("AC", 0)):
        if before:
            codes = cs.read_stream(dev, 4_600_000, (before + 1) * per + cs.K - 1,
                                   n_every=100_003)
        else:
            codes = torch.zeros(per + cs.K - 1, dtype=torch.int32, device=dev)
            if name == "AC":
                codes[1::2] = 1
        tk, cn = torch.zeros((1 << cs.TABLE_LOG2, 4), dtype=torch.int32, device=dev), \
            torch.zeros(1 << cs.TABLE_LOG2, dtype=torch.int32, device=dev)
        batch = lambda b: cs.chunk_of(codes[b * per: (b + 1) * per + cs.K - 1])[:2]
        for b in range(before):
            packed, sep = batch(b)
            keys = sortcount.window_keys_from_chunk(packed, sep, k=cs.K, n=per)
            if int(step(tk, cn, keys)[1]):
                raise RuntimeError(f"t1 {name}: pending windows while filling the table")
        packed, sep = batch(before)
        keys = sortcount.window_keys_from_chunk(packed, sep, k=cs.K, n=per)
        del codes, packed, sep
        fresh = lambda: (tk.clone(), cn.clone(), keys)
        t, c, _ = fresh()
        if int(step(t, c, keys)[1]):
            raise RuntimeError(f"t1 {name}: pending windows")
        out["digest"][name] = [digest(cs.occupied_rows(t, c))]
        del t, c
        out["ms"][name] = cs.cuda_ms_fresh(fresh, step, reps)
        del tk, cn, keys
        torch.cuda.empty_cache()
    return out


def bloom_worker(cs, dev, root: str, reps: int) -> dict:
    """The -b pass-1 step and pass-2 gate from K3's key columns (``bloom``
    above), CUDA-event medians from fresh copies of the filters or keys."""
    import statistics
    import time

    import torch
    from kaarme_tpu_torch.models import bloom_counter
    from kaarme_tpu_torch.ops import bloom, hashing, sortcount

    per = cs.TABLE_TILE * cs.TABLE_BATCH_TILES
    bits, hfn, _, _ = bloom_counter.make_filters(5_000_000, 0.01, "cpu")
    kernels = importlib.util.find_spec("kaarme_tpu_torch.ops.cuda_bloom") is not None
    if kernels:
        from kaarme_tpu_torch.ops import cuda_bloom

        scratch = [None]      # grown to the largest batch, then reused by every batch

        def insert(bf1, bf2, keys):
            scratch[0] = cuda_bloom.scratch_for(keys[0].shape[0], dev, scratch[0])
            n1, n2 = cuda_bloom.bloom_insert(bf1, bf2, keys, hfn, scratch[0])
            return bf1, bf2, n1, n2

        def gate(bf2, keys):
            return cuda_bloom.bloom_gate(bf2, keys, hfn)
    else:
        def insert(bf1, bf2, keys):
            valid = sortcount._is_sentinel_i32(keys) == 0
            r1, r2 = hashing.hash_words64(keys)
            return bloom.insert_batch(bf1, bf2, r1, r2, valid, hfn)

        def gate(bf2, keys):
            miss = sortcount._bloom_miss_mask(bf2, keys, hfn)
            return tuple(x | miss for x in keys)

    out = dict(root=root, api="B1 and B2" if kernels else
               "sentinel mask + hash_words64 + insert_batch; _bloom_miss_mask", ms={}, digest={},
               kernels={})

    def host_ms(prepare, fn):
        """Median host milliseconds from the call of ``fn(*prepare())`` to
        its return, on an idle card (one warm-up): the wrapper's Python and
        its launches, the card not waited for."""
        fn(*prepare())
        times = []
        for _ in range(reps):
            args = prepare()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    def measure(name, bf1, bf2, keys):
        """Digest and time the insert of ``keys`` into copies of the filters
        and the gate of copies of ``keys`` by the BF2 after it; returns
        the filters after the insert."""
        base = torch.stack(list(keys))
        fresh = lambda: (bf1.clone(), bf2.clone(), keys)
        r = insert(*fresh())
        out["digest"][f"{name}_insert"] = [digest(r[:2]), int(r[2]), int(r[3])]
        g = gate(r[1], tuple(base.clone().unbind(0)))
        out["digest"][f"{name}_gate"] = [digest(g)]
        after = r[:2]
        del r
        gate_fresh = lambda: (after[1], tuple(base.clone().unbind(0)))
        for step, fn, prep in (("insert", insert, fresh), ("gate", gate, gate_fresh)):
            out["ms"][f"{name}_{step}"] = cs.cuda_ms_fresh(prep, fn, reps)
            out["ms"][f"{name}_{step}_dev"] = cs.cuda_ms_queued(prep, fn, reps)
            out["ms"][f"{name}_{step}_host"] = host_ms(prep, fn)
        # each kernel's device time (and the memsets'), by the profiler
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                insert(*fresh())
                gate(*gate_fresh())
            torch.cuda.synchronize()
        out["kernels"][name] = {
            e.key[:60]: getattr(e, "device_time_total", 0) / reps / 1e3
            for e in prof.key_averages() if "bloom" in e.key or "Memset" in e.key}
        del g, base
        return after

    for name, k, before in (("k51", cs.K, 63), ("polyA", cs.K, 0), ("k13", 13, 7)):
        if before:
            codes = cs.read_stream(dev, 4_600_000, (before + 1) * per + k - 1, n_every=100_003)
        else:
            codes = torch.zeros(2 * per + k - 1, dtype=torch.int32, device=dev)
        bf1, bf2 = bloom.make_bloom(bits, dev), bloom.make_bloom(bits, dev)
        for b in range(max(before, 1)):
            bf1, bf2, _, _ = insert(bf1, bf2, cs.table_batch(codes, b, k)())
        keys = cs.table_batch(codes, max(before, 1), k)()
        del codes
        measure(name, bf1, bf2, keys)
        del bf1, bf2, keys
        torch.cuda.empty_cache()

    # two 2^26-window sort supersteps (a sort route's pass 1): the first on
    # empty filters, the second on the filters after the first
    n = cs.N_WINDOWS
    codes = cs.read_stream(dev, 4_600_000, 2 * n + cs.K - 1, n_every=100_003)
    bf1, bf2 = bloom.make_bloom(bits, dev), bloom.make_bloom(bits, dev)
    for step in range(2):
        packed, seps, _ = cs.chunk_of(codes[step * n: (step + 1) * n + cs.K - 1])
        keys = sortcount.window_keys_from_chunk(packed, seps, k=cs.K, n=n)
        del packed, seps
        bf1, bf2 = measure(f"superstep{step}", bf1, bf2, keys)
        del keys
        torch.cuda.empty_cache()
    return out


def bloom_e2e_worker(root: str, reps: int) -> dict:
    """The k=51 ``-b`` CLI runs of the shared FASTA (``bloom_e2e`` above)."""
    import hashlib
    import statistics
    import time

    import torch
    from kaarme_tpu_torch import cli

    path = os.environ["KT_FASTA"]
    out = dict(root=root, api="cli.run -b -u 5000000 -a 2, k=51", ms={}, digest={},
               peak_bytes={}, runs={})
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("skm", []), ("classic", ["--pipeline", "classic"]),
                            ("table", ["--backend", "table"])):
            dst = os.path.join(tmp, name + ".txt")
            argv = [path, "51", "-b", "-u", "5000000", "-a", "2", "-q", "-o", dst, *extra]
            runs = []
            for _ in range(reps + 1):           # the first run warms up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
                t0 = time.perf_counter()
                rc, counter = cli.run(argv)
                wall = time.perf_counter() - t0
                if rc:
                    raise RuntimeError(f"bloom_e2e {name}: the CLI exited {rc}")
                st = counter.stats
                runs.append(dict(wall=wall, write=st["write_seconds"], count=st["build_seconds"],
                                 # bloom_pass_seconds: the table's pass 1 before the tracer
                                 pass1=st.get("bloom_pass1_seconds", st.get("bloom_pass_seconds")),
                                 peak=torch.cuda.max_memory_allocated(),
                                 mallocs=torch.cuda.memory_stats().get("num_device_alloc", 0)
                                 - mallocs))
                del counter
            for key in ("wall", "pass1", "count", "write"):
                out["ms"][f"{name}_{key}"] = statistics.median(r[key] for r in runs[1:]) * 1e3
            out["runs"][name] = [{k: round(v * 1e3, 1) if k not in ("peak", "mallocs") else v
                                  for k, v in r.items()} for r in runs]
            out["peak_bytes"][name] = max(r["peak"] for r in runs[1:])
            with open(dst, "rb") as f:
                lines = sorted(f.read().splitlines())
            out["digest"][name] = [hashlib.sha256(b"\n".join(lines)).hexdigest(), len(lines)]
    return out


def table_worker(root: str, reps: int) -> dict:
    """The table route's count of the shared FASTA (``table`` above)."""
    import statistics
    import time

    import numpy as np
    from kaarme_tpu_torch.models.counter import CounterConfig, KmerCounter

    path = os.environ["KT_FASTA"]
    walls, steps = [], []
    for _ in range(reps + 1):           # the first run warms up
        t0 = time.perf_counter()
        counter = KmerCounter(CounterConfig(k=51, min_slots=8_000_000)).count_file(path)
        walls.append(time.perf_counter() - t0)
        steps.append(counter.stats["build_seconds"])
    tk, cn = counter.dump()
    order = np.lexsort(tk.T[::-1])
    return dict(root=root, api="KmerCounter.count_file, k=51",
                ms={"count_wall": statistics.median(walls[1:]) * 1e3,
                    "build_seconds": statistics.median(steps[1:]) * 1e3},
                digest={"table_k51": [int(tk[order].astype(np.int64).sum()),
                                      int((cn[order] * np.arange(1, cn.shape[0] + 1)).sum())]})


def _host_live_rows(cols, nd: int, words: int):
    """The host path before W1 (``models/sort_counter.live_rows_to_host``):
    the first ``nd`` store rows to the host, count-0 rows dropped."""
    import numpy as np
    import torch

    if not nd:
        return np.zeros((0, words), np.uint32), np.zeros((0,), np.int64)
    keys = torch.stack([c[:nd] for c in cols[:-1]], 1).cpu().numpy().view(np.uint32)
    cnt = cols[-1][:nd].cpu().numpy().astype(np.int64)
    live = cnt > 0
    return keys[live], cnt[live]


def _host_format_lines(tk, cn, k: int) -> bytes:
    """The host path before W1 (``models/sort_counter._format_lines``):
    one numpy byte matrix, the unused leading digit cells dropped."""
    import numpy as np

    n, W = tk.shape
    base4 = np.frombuffer(b"ACGT", np.uint8)[(np.arange(256)[:, None] >> [6, 4, 2, 0]) & 3]
    lut16 = np.concatenate([np.repeat(base4, 256, 0), np.tile(base4, (256, 1))], 1)
    halves = tk.astype(">u4").view(">u2").astype(np.uint16).reshape(n, 2 * W)
    D = len(str(int(cn.max())))
    m = np.empty((n, k + D + 2), np.uint8)
    m[:, :k] = np.take(lut16, halves, axis=0).reshape(n, 16 * W)[:, :k]
    m[:, k] = ord(" ")
    v = cn.astype(np.int64)
    for j in range(k + D, k, -1):
        m[:, j] = ord("0") + v % 10
        v //= 10
    m[:, -1] = ord("\n")
    ndig = np.ones(n, np.int64)
    for j in range(1, D):
        ndig += cn >= 10 ** j
    keep = np.ones(m.shape, bool)
    keep[:, k + 1: k + 1 + D] = np.arange(D)[None, :] >= (D - ndig)[:, None]
    return m[keep].tobytes()


def w1_worker(root: str, reps: int) -> dict:
    """The count file's write step on the k=51 skm and k=13 classic
    stores (``w1`` above)."""
    import hashlib
    import statistics
    import time

    import numpy as np
    import torch
    from kaarme_tpu_torch import cli

    path = os.environ["KT_FASTA"]
    new = importlib.util.find_spec("kaarme_tpu_torch.ops.writer") is not None
    out = dict(root=root, api="write_lines (W1)" if new else
               "live_rows_to_host + _format_lines (host)", ms={}, digest={})
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "counts.txt")
        for name, k in (("k51_skm", 51), ("k13_classic", 13)):
            rc, counter = cli.run([path, str(k), "-s", "8000000", "-a", "1", "-q", "-o", dst])
            if rc:
                raise RuntimeError(f"w1 {name}: the CLI exited {rc}")
            cfg = counter.cfg
            if new:
                from kaarme_tpu_torch.ops import writer

                def step():
                    return writer.write_lines(dst, counter.dump_columns(), k=cfg.k,
                                              mode=cfg.mode, min_abundance=cfg.min_abundance)
            else:
                def step():
                    if hasattr(counter, "finalize_device"):
                        cols, nd = counter.finalize_device()
                    else:
                        cols, nd = counter.prefix, counter.n_used
                    tk, cn = _host_live_rows(cols, nd, (k + 15) // 16)
                    cn = cn & 0xFFFF if cfg.mode == 0 else np.minimum(cn, 16383)
                    keep = cn >= cfg.min_abundance
                    tk, cn = tk[keep], cn[keep]
                    with open(dst, "wb") as f:
                        if tk.shape[0]:
                            f.write(_host_format_lines(tk, cn, k))
                    return int(tk.shape[0])
            times = []
            for _ in range(reps + 1):           # the first run warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lines = step()
                times.append(time.perf_counter() - t0)
            with open(dst, "rb") as f:
                out["digest"][name] = [hashlib.sha256(f.read()).hexdigest(), lines]
            out["ms"][name] = statistics.median(times[1:]) * 1e3
            del counter
            torch.cuda.empty_cache()
    return out


def e1_worker(cs, dev, reps: int) -> dict:
    """The finalize chunk's expansion (``e1`` above): the call, the card's
    time and the launches and aten ops of one call, of both routes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from kaarme_tpu_torch.ops import skm

    R = 1 << 20
    api = ("E1" if importlib.util.find_spec("kaarme_tpu_torch.ops.cuda_expand") is not None
           else "the plain chain")
    out = dict(api=api, ms={}, digest={}, launches={}, ops={}, bound_ms={})

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))

    for k in (cs.K, 201):
        g = torch.Generator(device=dev)
        g.manual_seed(k)
        wc = (15 + k + 15) // 16
        buf = torch.empty((wc + 2, R), dtype=torch.int32, device=dev)
        buf[:wc] = torch.randint(-(1 << 31), 1 << 31, (wc, R), generator=g, device=dev,
                                 dtype=torch.int64).to(torch.int32)
        buf[wc] = torch.randint(0, 16, (R,), generator=g, device=dev) << 26 | 1
        buf[wc + 1] = torch.randint(1, 6, (R,), generator=g, device=dev)
        buf[wc + 1, ::20] = 0
        cols = tuple(buf.unbind(0))
        w = (k + 15) // 16
        out["bound_ms"][f"k{k}"] = (R * 16 * (w + 1) + R * (wc + 2)) * 4 / 3.35e12 * 1e3
        for name, kernels in ((f"k{k}", "cuda"), (f"k{k}_plain", "plain")):
            fn = lambda: skm.expand_chunk(cols, k, kernels=kernels)
            out["digest"][name] = digest(fn())
            out["ms"][name] = cs.cuda_ms(fn, reps)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
            out["ms"][f"{name}_dev"] = sum(e.device_time_total for e in ev) / reps / 1e3
            out["launches"][name] = sum(e.count for e in ev) / reps
            Ops.n = 0
            with Ops():
                fn()
            out["ops"][name] = Ops.n
            torch.cuda.synchronize()
        del buf, cols
        torch.cuda.empty_cache()
    return out


def p1_worker(cs, dev, reps: int) -> dict:
    """One 8 MiB FASTA block to its transfer chunk (``p1`` above)."""
    import numpy as np
    import torch
    from kaarme_tpu_torch.io import fastio

    blk = cs.reads_fasta_bytes(60_000)[:8 << 20]
    raw = torch.frombuffer(bytearray(blk), dtype=torch.uint8)
    out = dict(ms={}, digest={})
    if importlib.util.find_spec("kaarme_tpu_torch.ops.cuda_parse") is None:
        from kaarme_tpu_torch.models.sort_counter import to_device

        def fn():
            packed, mask = fastio.pack_stream(fastio.encode_fasta(blk)[0])
            return to_device(packed, dev), to_device(mask, dev)

        out["api"] = "host encode + pack + copy"
        words, bits = fn()
        out["ms"]["block"] = cs.cuda_ms(fn, reps)
    else:
        from kaarme_tpu_torch.ops import cuda_parse

        raw = raw.to(dev)
        span = cs.N_WINDOWS + cs.K - 1

        def prepare():
            return (cuda_parse.ParseState(dev),
                    [(torch.zeros(-(-span // 16), dtype=torch.int32, device=dev),
                      torch.zeros(-(-span // 32), dtype=torch.int32, device=dev))])

        def run(state, chunks):
            cuda_parse.parse_pack(raw, fasta=True, state=state, chunks=chunks, base=0,
                                  sb=cs.N_WINDOWS, span=span)

        out["api"] = "P1"
        state, chunks = prepare()
        run(state, chunks)
        n = int(state.buf[2])
        words, bits = chunks[0][0][:-(-n // 16)], chunks[0][1][:-(-n // 32)]
        out["ms"]["block"] = cs.cuda_ms_fresh(prepare, run, reps)
        out["ms"]["block_dev"] = cs.cuda_ms_queued(prepare, run, reps)
    torch.cuda.synchronize()
    out["digest"]["block"] = digest([words, bits])
    out["bound_ms"] = (len(blk) + (words.numel() + bits.numel()) * 4) / 3.35e12 * 1e3
    out["codes"] = int(np.asarray(fastio.encode_fasta(blk)[0]).shape[0])
    return out


def worker(kernel: str, root: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch
    from kaarme_tpu_torch.ops import _build

    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    _build.lib()
    if kernel == "table":
        return table_worker(root, reps)
    if kernel == "w1":
        return w1_worker(root, reps)
    if kernel == "bloom_e2e":
        return bloom_e2e_worker(root, reps)
    if kernel == "t1":
        return t1_worker(cs, dev, root, reps)
    if kernel == "bloom":
        return bloom_worker(cs, dev, root, reps)
    if kernel == "e1":
        return dict(root=root, **e1_worker(cs, dev, reps))
    if kernel == "p1":
        return dict(root=root, **p1_worker(cs, dev, reps))
    api, calls = {"k1": k1_calls, "k2": k2_calls, "k3": k3_calls, "k4": k4_calls,
                  "k5": k5_calls}[kernel](cs, dev)
    out = dict(root=root, api=api, ms={}, digest={})
    for name, fn in calls.items():
        res = fn()
        cols, tail = res[:-1], res[-1]
        flat = [c for part in cols for c in (part if isinstance(part, (tuple, list)) else [part])]
        out["digest"][name] = [digest(flat), tail.reshape(-1).tolist()]
        del res, cols, flat
        out["ms"][name] = cs.cuda_ms(fn, reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k4", "k5", "t1", "bloom", "table",
                                         "w1", "bloom_e2e", "e1", "p1"),
                    required=True)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.kernel, a.other, a.reps)))
        return 0
    other = os.path.abspath(a.other)
    cs = chip_smoke()
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        if a.kernel in ("table", "w1", "bloom_e2e"):
            env["KT_FASTA"] = os.path.join(tmp, "reads.fa")
            cs.write_reads_fasta(env["KT_FASTA"], 4_600_000, 30)
        for root in (other, HERE, HERE, other):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--kernel",
                                  a.kernel, "--reps", str(a.reps), "--worker"],
                                 capture_output=True, text=True, cwd=root, env=env)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            out.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(out[-1]))
    same = len({json.dumps(r["digest"], sort_keys=True) for r in out}) == 1
    print(json.dumps({"kernel": a.kernel,
                      "other_ms": [out[0]["ms"], out[3]["ms"]],
                      "this_ms": [out[1]["ms"], out[2]["ms"]], "same_output": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
