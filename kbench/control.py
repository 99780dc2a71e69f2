#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, on the card.

    python3 kbench/control.py --workload CELL --seeds S1,S2,... [--program 1]

For each seed: the cell's input, then

- ``program`` (with ``--program 1``): one job of the port's entry point,
  judged as the window's last job is (the lower readings);
- the controls, each the plain reference put in the program's place
  with one guarantee of the configuration broken (the upper readings):
  ``chunk_seam``, every window that crosses an 8 MiB read boundary of
  the input lost (the k - 1 carry between the reader's chunks dropped);
  with ``-b``, ``one_pass_bloom`` too, a k-mer counted only from its
  second sight on (one pass, no exact recount), and ``no_gate``, the
  filter left out: every key in the store, the singletons with it (the
  count file is the same: ``-a 2`` drops them).

One JSON line per seed and side on standard output.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from kbench import gen, judge, run  # noqa: E402
from kbench.reference import kmer_count as ref  # noqa: E402

SEAM_BYTES = 8 << 20       # the port's reader reads 8 MiB chunks


def controls(cfg: dict, path: str, dev) -> dict:
    """{control name: (keys, counts, count-file bytes)} for the input at
    ``path``."""
    import torch

    k, flags = cfg["k"], cfg["flags"]
    kw = dict(k=k, mode=judge.flag(flags, "-m", 2), min_abundance=judge.flag(flags, "-a", 2))
    with open(path, "rb") as f:
        buf = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(dev)
    seams = torch.arange(SEAM_BYTES, buf.numel(), SEAM_BYTES, device=dev)
    base = (buf[seams] != ord("\n")) & (buf[seams] != ord(">"))
    cut = buf.clone()
    cut[seams[base]] = ord("N")
    out = {}
    keys, counts = ref.count_codes(ref.codes_from_fasta(cut), k)
    out["chunk_seam"] = (keys, counts, ref.render(keys, counts, **kw).cpu().numpy().tobytes())
    if "-b" in flags:
        keys, counts = ref.count_codes(ref.codes_from_fasta(buf), k)
        out["no_gate"] = (keys, counts, ref.render(keys, counts, **kw).cpu().numpy().tobytes())
        keep = counts > 1
        keys, counts = keys[keep], counts[keep] - 1
        out["one_pass_bloom"] = (keys, counts,
                                 ref.render(keys, counts, **kw).cpu().numpy().tobytes())
    return out


def readings(cell: dict, seed: int, program: bool, device: str = "cuda") -> list:
    """[(side, checks)] of one seed: the program's job, then each control,
    each judged in one key-hash part a card of the cell."""
    cfg, devs = cell["config"], run.cards(cell["chips"], device)
    work = tempfile.mkdtemp(prefix="kbench-control-")
    try:
        inp = gen.write_input(os.path.join(work, "reads.fa"), cell["params"], seed, cfg["k"])
        out, rows = [], list(run.reference_parts(cfg, inp, devs))
        if program:
            from kaarme_tpu_torch import cli

            counts_path = os.path.join(work, "reads.kaarme_counts")
            rc, counter = run._job(cli, [inp["path"], str(cfg["k"]), *cfg["flags"], "-o",
                                         counts_path, "--device", device], None)
            store, text = run.judged_outputs(counter, counts_path, cfg["k"], devs)
            del counter
            out.append(("program", run.compare(cfg, inp, rows, store, text, int(rc != 0))))
        for name, (keys, counts, text) in controls(cfg, inp["path"], devs[0]).items():
            store = run.joined(run.into_parts(keys, counts, devs))
            out.append((name, run.compare(cfg, inp, rows, store, text, 0)))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--program", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = run.load_cell(a.workload)
    import torch

    if not torch.cuda.is_available():
        print("error: the control is read on a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        for side, checks in readings(cell, seed, bool(a.program)):
            print(json.dumps(dict(workload=a.workload, seed=seed, side=side,
                                  correct=judge.ok(checks), checks=checks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
