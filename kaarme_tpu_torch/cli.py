"""Command-line interface of the PyTorch port.

The same surface as ``kaarme_tpu/cli.py`` (the reference's CLI), plus
``--device`` (default ``cuda``; asking for it without a card is an
error, never a silent CPU run) and ``--kernels`` (``cuda``: the
hand-written kernels; ``plain``: their plain PyTorch versions).

    python -m kaarme_tpu_torch.cli INPUT KLEN -s SLOTS [-m MODE] [-a MINABU]
                                   [-t THREADS] [-o OUT] [--device cuda|cpu]

Every route is ported: on the sort backend the super-k-mer pipeline
(k >= 16) and the classic pipeline (``--pipeline classic``, the only
route for k < 16), with ``--compactor merge`` (the linear run merge) on
the classic one; the probe table (``--backend table``); the two-pass
Bloom prefilter (``-b -u U [-f FPR]``) on each; and ``--devices N`` (a
power of two) on the sort backend, N shards on N cards, or on N CPU
shards with ``--device cpu`` (``parallel/``).  As in the JAX CLI,
``--devices`` refuses ``--backend table`` and ``-b``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .utils import trace


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI surface (reference: main.cpp:127-156), as
    ``kaarme_tpu/cli.py`` builds it, plus ``--device`` and ``--kernels``."""
    p = argparse.ArgumentParser(
        prog="kaarme_tpu_torch", description="Space-efficient k-mer counter (PyTorch / CUDA port)"
    )
    p.add_argument("INPUT", help="Input file (automatic format detection)")
    p.add_argument("KLEN", type=int, help="k-mer length")
    p.add_argument("-m", "--hash-table-type", type=int, default=2, choices=(0, 1, 2),
                   help="Hash table type: 0 for plain and 2 for kaarme (def. 2). "
                        "1 (the reference's undocumented legacy variant of the "
                        "kaarme table with identical counting semantics — "
                        "SURVEY.md section 2.3) is accepted as an alias for 2.")
    p.add_argument("-a", "--min-k-abu", type=int, default=2,
                   help="Minimum abundance threshold for the output k-mers (def. 2)")
    p.add_argument("-t", "--threads", type=int, default=3,
                   help="Number of working threads (def. 3; sizes host prefetch)")
    p.add_argument("-o", "--output-file", default="",
                   help="Output file where the k-mer counts will be stored")
    p.add_argument("-b", "--use-bfilter", action="store_true",
                   help="Use bloom filters to discard unique k-mers")
    p.add_argument("-f", "--bfilter-fpr", type=float, default=0.01,
                   help="Bloom filter false positive rate (def. 0.01)")
    p.add_argument("-s", "--hash-tab-size", type=int, default=None, help="Hash table size")
    p.add_argument("-u", "--unq-kmers", type=int, default=None,
                   help="Estimated number of unique k-mers")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard the table over this many devices (0 = single device)")
    p.add_argument("--backend", choices=("sort", "table"), default="sort",
                   help="Counting backend: 'sort' (sort/segment-reduce pipeline; "
                        "-b runs the two-pass Bloom prefilter on it) or 'table' "
                        "(open-addressing probe table in device memory, "
                        "written in slot order; -b gates its inserts on the "
                        "filter) (def. sort)")
    p.add_argument("--compactor", default="auto",
                   choices=("auto", "pallas", "xla", "interpret", "merge",
                            "merge_interpret"),
                   help="Sort-backend superstep variant: auto (Pallas compact "
                        "kernel on TPU, XLA elsewhere), merge (linear "
                        "run-merge kernel — sorts only the batch and streams "
                        "the prefix), or explicit overrides (def. auto)")
    p.add_argument("--pipeline", choices=("auto", "classic", "skm"),
                   default="auto",
                   help="Sort-backend counting pipeline: 'skm' deduplicates "
                        "minimizer runs (super-k-mers) before sorting "
                        "(faster; requires k >= 16); 'classic' sorts one "
                        "row per window; 'auto' picks skm when eligible "
                        "(def. auto)")
    p.add_argument("-q", "--quiet", action="store_true", help="Suppress the settings banner")
    p.add_argument("--query", action="store_true",
                   help="After counting, read k-mers from stdin and print their "
                        "counts (0 = absent, -1 = malformed) — the reference's "
                        "interactive point-lookup loop")
    p.add_argument("--histo", default="",
                   help="Also write a k-mer abundance spectrum (count -> #distinct "
                        "k-mers, one 'COUNT N' line each) to this file")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; an error without a card) "
                        "or 'cpu' (plain PyTorch path)")
    p.add_argument("--kernels", choices=("cuda", "plain"), default="cuda",
                   help="'cuda': the hand-written kernels on a CUDA device; "
                        "'plain': their plain PyTorch versions (def. cuda)")
    p.add_argument("--trace-out", default="",
                   help="Record the program's spans and counters and write them to this "
                        "file as Chrome trace-event JSON (Perfetto; microseconds of "
                        "time.perf_counter_ns)")
    return p


def _validate_reference(args) -> str:
    """``kaarme_tpu/cli.py``'s checks, messages and ``--pipeline auto``
    resolution (reference: main.cpp:144-151 for -s/-u/-b/-f)."""
    if args.KLEN < 2:
        return "KLEN must be >= 2"
    if (args.hash_tab_size is None) == (args.unq_kmers is None):
        return "exactly one of -s/--hash-tab-size or -u/--unq-kmers is required"
    if args.use_bfilter and args.unq_kmers is None:
        return "-b/--use-bfilter requires -u/--unq-kmers"
    if args.unq_kmers is not None and not args.use_bfilter:
        return "-u/--unq-kmers requires -b/--use-bfilter"
    if not (3 <= args.threads <= 64):
        return "-t/--threads must be in [3, 64]"
    if not (0.001 <= args.bfilter_fpr <= 0.999):
        return "-f/--bfilter-fpr must be in [0.001, 0.999]"
    # reject silently-ignored flag combinations instead of overriding by
    # dispatch order (the sharded path has no table backend or Bloom pass)
    if args.devices > 1 and args.backend == "table":
        return "--backend table does not support --devices; use the sort backend"
    if args.devices > 1 and args.use_bfilter:
        return "-b/--use-bfilter does not support --devices yet"
    if args.pipeline == "auto":
        # skm when eligible: k >= 16, sort backend
        args.pipeline = "skm" if (args.KLEN >= 16
                                  and args.backend == "sort") else "classic"
    if args.pipeline == "skm":
        if args.KLEN < 16:
            return "--pipeline skm requires KLEN >= 16"
        if args.backend != "sort":
            return "--pipeline skm supports only the sort backend"
    if not os.path.isfile(args.INPUT):
        return f"input file {args.INPUT} does not exist"
    return ""


def validate(args) -> str:
    err = _validate_reference(args)
    if err:
        return err
    if args.compactor not in ("auto", "merge"):
        return (f"--compactor {args.compactor} is a JAX-package variant; the port takes "
                "'auto' or 'merge' and picks kernels with --kernels cuda|plain")
    return ""


def config_kwargs(args) -> dict:
    """The counter configuration's keyword arguments for validated CLI
    arguments (library callers build a config the CLI would, then change
    what the CLI has no flag for, such as ``segpack``)."""
    # batch size from the input size: file bytes bound the window count;
    # with -b the store is sized from the filter after pass 1, not by -s
    est = max(os.path.getsize(args.INPUT), 1)
    blog2 = max(12, min(24, (est - 1).bit_length()))
    return dict(k=args.KLEN, min_slots=0 if args.use_bfilter else args.hash_tab_size,
                mode=args.hash_table_type, min_abundance=args.min_k_abu,
                batch_windows=1 << blog2, prefix_cap=1 << max(12, min(22, blog2)),
                device=args.device, kernels=args.kernels)


def sharded_config_kwargs(args) -> dict:
    """The sharded counters' configuration for validated CLI arguments
    with ``--devices`` > 1: ``kaarme_tpu/cli.py``'s per-device sizing."""
    from .ops.sortcount import next_store_size

    est = max(os.path.getsize(args.INPUT), 1)
    blog2 = max(10, min(22, (est // args.devices - 1).bit_length()))
    # -s sizes the distinct store like the reference's table size;
    # prefix_cap is PER SHARD, so split it (growth covers the rest)
    cap = 1 << max(10, min(20, blog2))
    if args.hash_tab_size:
        cap = max(cap, next_store_size(-(-args.hash_tab_size // args.devices)))
    return dict(k=args.KLEN, mode=args.hash_table_type, min_abundance=args.min_k_abu,
                batch_windows=1 << blog2, prefix_cap=cap, compactor=args.compactor,
                kernels=args.kernels)


def run(argv=None):
    """Parse, count and write; returns (exit code, counter or None).
    With ``--trace-out PATH`` the run's span and counter records go to
    PATH (``utils/trace.py``)."""
    args = build_parser().parse_args(argv)
    if not args.trace_out:
        return _run(args)
    was, since = trace.record(True), trace.mark()
    try:
        return _run(args)
    finally:
        trace.record(was)
        trace.write_chrome(args.trace_out, since)


def _run(args):
    err = validate(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1, None

    from .io.reader import FormatError, sniff_format
    from .models import bloom_counter
    from .models.counter import CounterConfig, KmerCounter
    from .models.skm_counter import SkmCounter, SkmCounterConfig
    from .models.sort_counter import SortCounterConfig, SortKmerCounter
    from .parallel import (ShardedSkmConfig, ShardedSkmCounter, ShardedSortConfig,
                           ShardedSortCounter, make_mesh)
    from .utils.device import resolve_device

    try:
        fmt, gz = sniff_format(args.INPUT)
    except (FormatError, OSError) as e:
        print(f"Input file {args.INPUT} is ill-formed: {e}", file=sys.stderr)
        return 1, None
    out = args.output_file
    if not out:
        out = os.path.splitext(os.path.basename(args.INPUT))[0] + ".kaarme_counts"

    if not args.quiet:
        print("Running settings:")
        print(f"  input file:               {os.path.basename(args.INPUT)}")
        fmt_name = {"fasta": "FASTA", "fastq": "FASTQ"}.get(fmt, "ONE-STR-PER-LINE")
        print(f"  input format:             {fmt_name}")
        print(f"  gzip compressed:          {'yes' if gz else 'no'}")
        print(f"  k-mer length:             {args.KLEN}")
        print(f"  min. abundance threshold: {args.min_k_abu}")
        print(f"  hash table type:          {'plain' if args.hash_table_type == 0 else 'kaarme'}")
        print(f"  using bloom filters:      {'yes' if args.use_bfilter else 'no'}")
        if args.use_bfilter:
            print(f"    est. unique k-mers:     {args.unq_kmers}")
            print(f"    false positive rate:    {args.bfilter_fpr}")
        else:
            print(f"    est. hash table size:   {args.hash_tab_size}")
        print(f"  output file:              {out}")
        print(f"  device:                   {args.device} ({args.kernels} kernels)"
              + (f", {args.devices} shards" if args.devices > 1 else ""))

    kw = config_kwargs(args)
    bloom = (args.unq_kmers, args.bfilter_fpr) if args.use_bfilter else None
    try:
        if args.devices > 1:
            # one shard per device: N cards, or N CPU shards
            try:
                devices = make_mesh(args.devices, args.device)
            except ValueError as e:
                raise ValueError(f"--devices {args.devices}: {e}") from None
            skw = sharded_config_kwargs(args)
            counter = (ShardedSkmCounter(ShardedSkmConfig(**skw), devices)
                       if args.pipeline == "skm"
                       else ShardedSortCounter(ShardedSortConfig(**skw), devices))
        elif args.backend == "table":
            table_kw = dict(k=args.KLEN, mode=args.hash_table_type,
                            min_abundance=args.min_k_abu, device=args.device,
                            kernels=args.kernels)
            counter = None if bloom else KmerCounter(
                CounterConfig(min_slots=args.hash_tab_size, **table_kw))
        elif args.pipeline == "skm":
            # the skm pipeline has no merge variant: --compactor is ignored
            cfg = SkmCounterConfig(**kw)
            counter = (bloom_counter.BloomSkmCounter(cfg, *bloom) if bloom
                       else SkmCounter(cfg))
        else:
            cfg = SortCounterConfig(compactor=args.compactor, **kw)
            counter = (bloom_counter.BloomSortCounter(cfg, *bloom) if bloom
                       else SortKmerCounter(cfg))
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    prefetch = max(1, args.threads - 2)
    if bloom and args.backend == "table":
        # two passes over the file; the table is sized from the filter
        counter = bloom_counter.bloom_count_file(
            bloom_counter.BloomCounterConfig(expected_unique=args.unq_kmers,
                                             fpr=args.bfilter_fpr, **table_kw),
            args.INPUT, prefetch=prefetch)
    elif bloom:
        # two passes over the file: fill the filter, then count its hits
        counter.count_file_two_pass(args.INPUT, prefetch=prefetch)
    else:
        counter.count_file(args.INPUT, prefetch=prefetch)

    n = counter.write_output(out)
    if args.histo:
        import numpy as np

        _, cn = counter.dump()
        cn = counter._clip(cn)
        spec = np.bincount(cn[cn > 0])
        with open(args.histo, "w") as f:
            for c in np.nonzero(spec)[0]:
                if c > 0:
                    f.write(f"{c} {spec[c]}\n")
    used, cap = counter.occupancy()
    if not args.quiet:
        # both passes with -b: the count span holds pass 2 alone
        build_s = counter.stats["build_seconds"] + counter.stats.get("bloom_pass1_seconds", 0.0)
        print(f"Time used for hash table construction: {build_s * 1e6:.0f} microseconds")
        print(f"Time used for writing k-mers: {counter.stats['write_seconds'] * 1e6:.0f} microseconds")
        print(f"Hash table slots in use: {used}/{cap}")
        print(f"K-mers written: {n}")

    if args.query:
        # point lookups: dump once, sort the probe table's dump (slot
        # order; the sort backend's is sorted), binary-search per stdin line
        import numpy as np

        from .ops.sortcount import lookup_sorted
        from .utils import codec

        tk, cn = counter.dump()
        if args.backend == "table":
            order = np.lexsort(tuple(tk[:, i] for i in range(tk.shape[1] - 1, -1, -1)))
            tk, cn = tk[order], cn[order]
        for line in sys.stdin:
            qk = line.strip()
            if not qk:
                continue
            if len(qk) != args.KLEN or any(ch not in "ACGTacgt" for ch in qk):
                print(-1)
                continue
            q = codec.pack_kmer(codec.canonical(qk.upper()))[None, :]
            c = lookup_sorted(tk, cn, q.astype(np.uint32))[0]
            print(int(counter._clip(np.asarray([c], np.int64))[0]))
    return 0, counter


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
