"""Command-line interface of the PyTorch port.

The same surface as ``kaarme_tpu/cli.py`` (the reference's CLI), plus
``--device`` (default ``cuda``; asking for it without a card is an
error, never a silent CPU run) and ``--kernels`` (``cuda``: the
hand-written kernels; ``plain``: their plain PyTorch versions).

    python -m kaarme_tpu_torch.cli INPUT KLEN -s SLOTS [-m MODE] [-a MINABU]
                                   [-t THREADS] [-o OUT] [--device cuda|cpu]

Only the single-device super-k-mer pipeline (k >= 16, sort backend) is
ported; every other route is refused with a "not yet ported" error.
"""

from __future__ import annotations

import os
import sys
import time

from kaarme_tpu import cli as _ref_cli


def build_parser():
    p = _ref_cli.build_parser()
    p.prog = "kaarme_tpu_torch"
    p.description = "Space-efficient k-mer counter (PyTorch / CUDA port)"
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; an error without a card) "
                        "or 'cpu' (plain PyTorch path)")
    p.add_argument("--kernels", choices=("cuda", "plain"), default="cuda",
                   help="'cuda': the hand-written kernels on a CUDA device; "
                        "'plain': their plain PyTorch versions (def. cuda)")
    return p


def validate(args) -> str:
    err = _ref_cli.validate(args)
    if err:
        return err
    if args.use_bfilter:
        return "-b/--use-bfilter (Bloom prefilter) is not yet ported"
    if args.backend != "sort":
        return f"--backend {args.backend} is not yet ported"
    if args.devices > 1:
        return "--devices > 1 (multi-device counting) is not yet ported"
    if args.compactor != "auto":
        return f"--compactor {args.compactor} is not yet ported"
    if args.pipeline != "skm":
        return "the classic pipeline (--pipeline classic, or KLEN < 16) is not yet ported"
    return ""


def run(argv=None):
    """Parse, count and write; returns (exit code, counter or None)."""
    args = build_parser().parse_args(argv)
    err = validate(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1, None

    from kaarme_tpu.io.reader import FormatError, sniff_format

    from .models.skm_counter import SkmCounter, SkmCounterConfig

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
        print("  using bloom filters:      no")
        print(f"    est. hash table size:   {args.hash_tab_size}")
        print(f"  output file:              {out}")
        print(f"  device:                   {args.device} ({args.kernels} kernels)")

    # batch size from the input size: file bytes bound the window count
    est = max(os.path.getsize(args.INPUT), 1)
    blog2 = max(12, min(24, (est - 1).bit_length()))
    try:
        counter = SkmCounter(SkmCounterConfig(
            k=args.KLEN, min_slots=args.hash_tab_size, mode=args.hash_table_type,
            min_abundance=args.min_k_abu, batch_windows=1 << blog2,
            prefix_cap=1 << max(12, min(22, blog2)), device=args.device,
            kernels=args.kernels))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    t0 = time.perf_counter()
    counter.count_file(args.INPUT, prefetch=max(1, args.threads - 2))
    build_s = time.perf_counter() - t0

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
        print(f"Time used for hash table construction: {build_s * 1e6:.0f} microseconds")
        print(f"Time used for writing k-mers: {counter.stats['write_seconds'] * 1e6:.0f} microseconds")
        print(f"Hash table slots in use: {used}/{cap}")
        print(f"K-mers written: {n}")

    if args.query:
        # point lookups: dump once, binary-search per stdin line
        import numpy as np

        from kaarme_tpu.utils import codec

        from .ops.sortcount import lookup_sorted

        tk, cn = counter.dump()
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
