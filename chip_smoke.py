#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Run from the repository root.  It builds the port's CUDA kernels from
``kaarme_tpu_torch/csrc`` (into ``build/``), then:

1. K1 (dense run segmentation) at the main path's shape (k=51, 2^26
   windows of 150 bp reads with separators and N patches): kernel ==
   plain PyTorch version, and an overflow case that must leave a guard
   region past ``cap`` untouched;
2. K2 (segment-sum + compaction) in embedded mode at the run-store
   merge's shape (6 columns) and in full_sum mode at the finalize's
   shape (4 key columns + count): kernel == plain;
3. the CLI end to end on small inputs (k=31 and k=51, -m 0 and -m 2)
   against a string-based golden count;
4. the CLI at full size: a random 4.6 Mb genome, 150 bp reads at 30x
   coverage, k=51, ``-s 8000000 -a 1``, with both kernels' launch
   counters > 0, the counts summing to the number of valid windows, and
   the count file byte-identical to the same run with ``--kernels plain``.

Each phase raises on failure (non-zero exit).  The last lines are the
kernel table as JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

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


def phase_k1(dev):
    import torch
    from kaarme_tpu_torch.ops import cuda_skm, sortcount

    L = N_WINDOWS + K - 1
    codes = read_stream(dev, 4_600_000, L, n_every=100_003)
    cap = sortcount.next_store_size(N_WINDOWS // 8)     # the counter's first capacity
    got = cuda_skm.run_rows_dense(codes, k=K, n=N_WINDOWS, cap=cap)
    want = cuda_skm.run_rows_dense_torch(codes, k=K, n=N_WINDOWS, cap=cap)
    torch.cuda.synchronize()
    rows = want[1].tolist()
    if got[1].tolist() != rows or rows[0] > cap:
        raise AssertionError(f"K1 rows {got[1].tolist()} vs plain {rows} (cap {cap})")
    err = max_abs_err(got[0], want[0])
    if err:
        raise AssertionError(f"K1 kernel != plain (max abs err {err})")
    # overflow: a capacity below the live rows; nothing may land past it
    small, guard = rows[0] // 3, 4096
    Wc = cuda_skm.content_words(K)
    out = torch.full((Wc + 1, small + guard), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    ocols, orows = cuda_skm.launch_dense(codes, K, N_WINDOWS, out, small)
    torch.cuda.synchronize()
    if orows.tolist() != rows:
        raise AssertionError(f"K1 overflow rows {orows.tolist()} != {rows}")
    if not bool((out[:, small:] == 0x5A5A5A5A).all()):
        raise AssertionError("K1 wrote past cap")
    err = max(err, max_abs_err(ocols, [c[:small] for c in want[0]]))
    if err:
        raise AssertionError("K1 overflow prefix != plain")
    ms = cuda_ms(lambda: cuda_skm.run_rows_dense(codes, k=K, n=N_WINDOWS, cap=cap))
    plain_ms = cuda_ms(lambda: cuda_skm.run_rows_dense_torch(codes, k=K, n=N_WINDOWS, cap=cap))
    print(f"K1 skm_dense k={K} n={N_WINDOWS} cap={cap} rows={rows[0]} "
          f"overflow cap={small}: guard intact; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms), got


def phase_k2(dev, k1_out):
    import torch
    from kaarme_tpu_torch.ops import cuda_compact, skm, sortcount

    (cols, rows) = k1_out
    r = int(rows[0])
    w = skm.store_words(K)
    # merge shape: the distinct store after one superstep (the prefix)
    # merged with the same superstep's rows again, as superstep 2 does
    rows_cols = tuple(c[:r] for c in cols)
    s1 = sortcount.lexsort(list(rows_cols), num_keys=w)
    ok, oc, nd1 = cuda_compact.segsum_compact_torch(s1, None, ebits=skm.EBITS)
    n1 = int(nd1[0])
    prefix = [c[:n1] for c in ok] + [oc[:n1]]
    merge = [torch.cat([prefix[i], rows_cols[i]]) for i in range(w - 1)]
    merge.append(torch.cat([prefix[w - 1] | prefix[-1], rows_cols[w - 1]]))
    s = sortcount.lexsort(merge, num_keys=w)
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
    print(f"K2 segsum_compact embedded ebits=26: {w} cols x {s.shape[1]} rows, "
          f"nd={n1}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # finalize shape: expand the distinct runs (count 2 each now) to k-mers
    runs = [c[:n1] for c in got[0]] + [got[1][:n1]]
    ex = skm.expand_chunk(tuple(runs), K)
    fs = sortcount.lexsort(list(ex[:-1]) + [ex[-1]], num_keys=len(ex) - 1)
    keys, cnt = fs[:-1], fs[-1].contiguous()
    fgot = cuda_compact.segsum_compact(keys, cnt)
    fwant = cuda_compact.segsum_compact_torch(keys, cnt)
    torch.cuda.synchronize()
    ferr = max_abs_err(fgot, fwant)
    if ferr or fgot[2].tolist() != fwant[2].tolist():
        raise AssertionError(f"K2 full_sum kernel != plain (max abs err {ferr})")
    fms = cuda_ms(lambda: cuda_compact.segsum_compact(keys, cnt))
    fplain = cuda_ms(lambda: cuda_compact.segsum_compact_torch(keys, cnt))
    print(f"K2 segsum_compact full_sum: {keys.shape[0]}+1 cols x {keys.shape[1]} rows, "
          f"nd={int(fwant[2][0])}; kernel {fms:.3f} ms, plain {fplain:.3f} ms")
    return dict(max_abs_err=max(err, ferr), ms=ms, plain_ms=plain_ms,
                full_sum_ms=fms, full_sum_plain_ms=fplain)


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
    for k in (31, 51):
        gold = golden(reads, k)
        for mode, abu in ((0, 1), (2, 2)):
            out = os.path.join(tmp, f"small_{k}_{mode}.txt")
            rc, _ = cli.run([path, str(k), "-s", "100000", "-m", str(mode), "-a", str(abu),
                             "-q", "-o", out])
            if rc:
                raise AssertionError(f"small CLI run k={k} -m {mode} exited {rc}")
            clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
            want = {km: clip(c) for km, c in gold.items() if clip(c) >= abu}
            with open(out, "rb") as f:
                got = {ln.split()[0]: int(ln.split()[1]) for ln in f.read().splitlines()}
            if got != want:
                raise AssertionError(f"small CLI k={k} -m {mode}: {len(got)} k-mers vs "
                                     f"golden {len(want)}")
            print(f"small end to end k={k} -m {mode} -a {abu}: {len(got)} k-mers == golden")


def phase_full(tmp):
    from kaarme_tpu_torch import cli
    from kaarme_tpu_torch.ops import cuda_compact, cuda_skm

    path = os.path.join(tmp, "ecoli30x.fa")
    t0 = time.perf_counter()
    n_reads, _ = write_reads_fasta(path, 4_600_000, 30)
    print(f"full size input: {n_reads} reads x 150 bp (30x of 4.6 Mb), "
          f"{os.path.getsize(path)} bytes, written in {time.perf_counter() - t0:.3f} s")
    out_k, out_p = os.path.join(tmp, "kernels.txt"), os.path.join(tmp, "plain.txt")
    argv = [path, str(K), "-s", "8000000", "-a", "1", "-q"]

    cuda_skm.run_rows_dense.launches = 0
    cuda_compact.segsum_compact.launches = 0
    t0 = time.perf_counter()
    rc, counter = cli.run(argv + ["-o", out_k])
    wall = time.perf_counter() - t0
    launches = {"skm_dense": cuda_skm.run_rows_dense.launches,
                "segsum_compact": cuda_compact.segsum_compact.launches}
    if rc:
        raise AssertionError(f"full-size CLI run exited {rc}")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    _, cnt = counter.dump()
    windows = n_reads * (150 - K + 1)
    if int(cnt.sum()) != windows:
        raise AssertionError(f"sum of counts {int(cnt.sum())} != valid windows {windows}")
    st = counter.stats
    distinct = counter.distinct_kmers()
    print(f"full size k={K}: distinct {distinct}, sum of counts {int(cnt.sum())} == "
          f"valid windows; launches {launches}; supersteps {st['batches']}, "
          f"store grow events {st['grow_events']}, row replays {st['slot_grow_events']}")
    print(f"full size k={K}: count {st['build_seconds']:.3f} s "
          f"({st['windows_processed'] / st['build_seconds']:.0f} windows/s), write "
          f"{st['write_seconds']:.3f} s (finalize {st['finalize_seconds']:.3f} s of it), "
          f"CLI wall {wall:.3f} s")

    t0 = time.perf_counter()
    rc, plain = cli.run(argv + ["-o", out_p, "--kernels", "plain"])
    pwall = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"plain full-size CLI run exited {rc}")
    if not filecmp.cmp(out_k, out_p, shallow=False):
        raise AssertionError("count file differs between the kernels and the plain route")
    ps = plain.stats
    print(f"full size, plain route: byte-identical count file; count "
          f"{ps['build_seconds']:.3f} s, write {ps['write_seconds']:.3f} s (finalize "
          f"{ps['finalize_seconds']:.3f} s of it), CLI wall {pwall:.3f} s")
    return launches


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
    with tempfile.TemporaryDirectory() as tmp:
        phase_small(tmp)
        launches = phase_full(tmp)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    table = {"kernels": [
        dict(name="skm_dense", route="cuda", source="kaarme_tpu_torch/csrc/skm_dense.cu",
             replaces="kaarme_tpu/ops/pallas_skm.py:564", launches=launches["skm_dense"],
             **k1),
        dict(name="segsum_compact", route="cuda",
             source="kaarme_tpu_torch/csrc/segsum_compact.cu",
             replaces="kaarme_tpu/ops/pallas_compact.py:520",
             launches=launches["segsum_compact"], **k2),
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
