#!/usr/bin/env python3
"""Time K1 of two checkouts on one card, in turns, from one transfer chunk.

    python3 time_k1.py OTHER_ROOT [--reps 5]

Run from the repository root.  Times ``kaarme_tpu_torch.ops.cuda_skm.
run_rows_dense`` of this checkout and of the checkout at OTHER_ROOT (for
example the parent commit, unpacked with ``git archive``) on chip_smoke.py's
K1 chunk (``read_stream`` + ``chunk_of``): k=51, 2^26 windows of 150 bp
reads sampled from a random 4.6 Mb genome, with N patches, cap 2^23 (the
skm counter's first capacity), separators as a sparse list.  Where a
checkout's K1 takes codes (before the chunk-input kernel), the timed call
is ``sortcount.codes_from_chunk`` followed by it, as its main path ran
them.  Each checkout runs in its own process (the packages share a name),
in the order other, this, this, other; each process builds its kernels
first and prints one JSON line: CUDA-event median of ``--reps`` calls after
a warm-up, rows, and a digest of the output, which must agree.  The card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CAP = 1 << 23


def chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch
    from kaarme_tpu_torch.ops import _build, cuda_skm, sortcount

    cs = chip_smoke()
    k, n = cs.K, cs.N_WINDOWS
    dev = torch.device("cuda", 0)
    _build.lib()
    packed, sep, _ = cs.chunk_of(cs.read_stream(dev, 4_600_000, n + k - 1, n_every=100_003))
    if next(iter(inspect.signature(cuda_skm.run_rows_dense).parameters)) == "codes":
        api = "codes_from_chunk + K1 (codes input)"

        def fn():
            codes = sortcount.codes_from_chunk(packed, sep, k=k, n=n, dense=False)
            return cuda_skm.run_rows_dense(codes, k=k, n=n, cap=CAP)
    else:
        api = "K1 (chunk input)"

        def fn():
            return cuda_skm.run_rows_dense(packed, sep, k=k, n=n, cap=CAP, dense=False)

    cols, rows = fn()
    digest = sum(int((c.long() * (i + 1)).sum()) for i, c in enumerate(cols))
    return dict(root=root, api=api, ms=cs.cuda_ms(fn, reps), rows=rows.tolist(), digest=digest)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.other, a.reps)))
        return 0
    other = os.path.abspath(a.other)
    print(chip_smoke().sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    out = []
    for root in (other, HERE, HERE, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--reps",
                              str(a.reps), "--worker"], capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        out.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(out[-1]))
    same = len({(json.dumps(r["rows"]), r["digest"]) for r in out}) == 1
    print(json.dumps({"other_ms": [out[0]["ms"], out[3]["ms"]],
                      "this_ms": [out[1]["ms"], out[2]["ms"]], "same_output": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
