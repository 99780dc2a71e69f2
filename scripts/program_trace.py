#!/usr/bin/env python3
"""The program's own spans against the benchmark's trace, on a card.

    python3 scripts/program_trace.py split --workload CELL --seed N [--seconds 20] [--out DIR]
    python3 scripts/program_trace.py cost --workload CELL --seeds N1,N2,.. [--seconds 20]

Run from the root of a checkout, on a machine with the cell's card.

``split`` runs one traced window of the cell (``kbench/run.py``'s
``run_cell`` with ``--trace 1``) with the program's recording on
(``kaarme_tpu_torch.utils.trace.record``) and reads the device trace
twice through ``kbench.trace.device_summary``: once with the harness's
spans, once with the program's.  It prints one JSON object: the card's
idle time of each harness bucket (``count_file``, ``count_file_two_pass``,
``write_output``, ``reader_wait``) split by the program's innermost span
there; the program's and the harness's ``reader_wait`` totals over the
window's jobs; the program's spans per job with their self times and
children; its counters per job.  ``--out DIR`` also writes the window's
program records as Chrome trace-event JSON.

``cost`` measures what recording costs: for each seed one run with
recording off and one with it on, in turns (off/on, then on/off), in one
process, and prints ``kmer_rate`` of each run, then the medians and
spreads (quartile distance over the median) of each side.
"""

import argparse
import json
import os
import statistics
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BUCKETS = ("count_file", "count_file_two_pass", "write_output", "reader_wait")


def _parents(recs) -> list:
    """Index of each record's enclosing record on its thread, or None."""
    out = [None] * len(recs)
    by_thread = {}
    for i, r in enumerate(recs):
        by_thread.setdefault(r[1], []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (recs[i][2], -recs[i][3]))
        open_ = []
        for i in idx:
            while open_ and recs[open_[-1]][3] <= recs[i][2]:
                open_.pop()
            out[i] = open_[-1] if open_ else None
            open_.append(i)
    return out


def _clip(recs, segs, main):
    """Program records of the main thread cut to the segments ``segs``."""
    out = []
    for s, e in segs:
        for r in recs:
            if r[1] == main and r[2] < e and r[3] > s:
                out.append((r[0], main, max(r[2], s), min(r[3], e)))
    return out


def span_table(recs, n_jobs: int) -> dict:
    """Per job: each span name's total, self time and children's totals
    by name (seconds), and the largest gap between total and self plus
    children over the spans of that name (0 by construction when the
    children nest)."""
    from kaarme_tpu_torch.utils import trace

    self_ns = trace.self_ns(recs)
    parents = _parents(recs)
    table = {}
    kids = {}
    for i, r in enumerate(recs):
        t = table.setdefault(r[0], dict(total=0.0, self=0.0, n=0, children={}))
        t["total"] += (r[3] - r[2]) / 1e9
        t["self"] += self_ns[i] / 1e9
        t["n"] += 1
        p = parents[i]
        if p is not None:
            c = table.setdefault(recs[p][0], dict(total=0.0, self=0.0, n=0, children={}))
            c["children"][r[0]] = c["children"].get(r[0], 0.0) + (r[3] - r[2]) / 1e9
            kids[p] = kids.get(p, 0) + (r[3] - r[2])
    worst = {}
    for i, r in enumerate(recs):
        gap = abs((r[3] - r[2]) - self_ns[i] - kids.get(i, 0)) / max(r[3] - r[2], 1)
        worst[r[0]] = max(worst.get(r[0], 0.0), gap)
    for name, t in table.items():
        t["total"] /= n_jobs
        t["self"] /= n_jobs
        t["children"] = {k: v / n_jobs for k, v in sorted(t["children"].items())}
        t["max_rel_gap"] = worst.get(name, 0.0)
    return table


def split(cell: dict, seed: int, seconds: float, out_dir: str, device: str = "cuda") -> dict:
    from kaarme_tpu_torch.utils import trace
    from kbench import run
    from kbench import trace as btr

    seen = {}
    orig = btr.device_summary

    def keep(events, spans, anchor_ns, w0, w1):
        seen.update(events=events, spans=spans, anchor=anchor_ns, w0=w0, w1=w1)
        return orig(events, spans, anchor_ns, w0, w1)

    btr.device_summary = keep
    trace.clear()
    mark = trace.mark()
    trace.record(True)
    try:
        res = run.run_cell(cell, seed, seconds, True, device=device)
    finally:
        trace.record(False)
        btr.device_summary = orig
    ev, hs, anchor, w0, w1 = (seen[k] for k in ("events", "spans", "anchor", "w0", "w1"))
    main = hs.main
    assert main == threading.get_ident()
    inside = [r for r in trace.records() if w0 <= r[2] and r[3] <= w1]
    prog = [r for r in inside if r[1] == main]
    hrec = [r for r in hs.records if w0 <= r[2] and r[3] <= w1]
    jobs = [r for r in hrec if r[0] == "job"]
    n_jobs = len(jobs)

    whole = orig(ev, hs, anchor, w0, w1)
    by_prog = orig(ev, trace.program_spans(prog, main), anchor, w0, w1)
    harness_idle = dict(whole["idle_gaps"])
    buckets = {}
    for b in BUCKETS:
        segs = [(s, e) for s, e, n in btr._segments(hs.records, main)
                if n == b and e > w0 and s < w1]
        if not segs:
            continue
        s = orig(ev, trace.program_spans(_clip(prog, segs, main), main), anchor, w0, w1)
        named = {n: v for n, v in s["idle_gaps"] if n != "harness"}
        named["(no program span)"] = harness_idle.get(b, 0.0) - sum(named.values())
        buckets[b] = dict(idle_s=harness_idle.get(b, 0.0),
                          by_program_span=dict(sorted(named.items(), key=lambda kv: -kv[1])))

    rw_prog = sum(r[3] - r[2] for r in prog if r[0] == "reader_wait") / 1e9
    rw_harness = sum(r[3] - r[2] for r in hrec if r[0] == "reader_wait") / 1e9
    counters = {}
    for j in jobs:
        last = {}
        for name, tid, t, total in trace.counter_records():
            if j[2] <= t <= j[3] and total is not None:
                last[name] = total
        for name, v in last.items():
            counters[name] = counters.get(name, 0) + v / n_jobs
    out = dict(workload=cell["name"], seed=seed, jobs=n_jobs, correct=res["correct"],
               device=res["device"]["kind"], metrics=res["metrics"],
               window_s=whole["window_s"], busy_s=whole["busy_s"],
               idle_by_harness_span=whole["idle_gaps"],
               idle_by_program_span=by_prog["idle_gaps"], buckets=buckets,
               reader_wait=dict(program_s=rw_prog, harness_s=rw_harness,
                                rel_diff=(rw_harness - rw_prog) / rw_harness if rw_harness else None),
               spans_per_job=span_table(prog, n_jobs),
               other_threads_per_job=span_table([r for r in inside if r[1] != main], n_jobs),
               counters_per_job=counters)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        trace.write_chrome(os.path.join(out_dir, f"{cell['name']}.program_trace.json"), mark)
    trace.clear()
    return out


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def cost(cell: dict, seeds, seconds: float, device: str = "cuda") -> dict:
    from kaarme_tpu_torch.utils import trace
    from kbench import run

    runs = {0: [], 1: []}
    for i, seed in enumerate(seeds):
        for on in ((0, 1) if i % 2 == 0 else (1, 0)):
            trace.clear()
            trace.record(bool(on))
            try:
                res = run.run_cell(cell, seed, seconds, False, device=device)
            finally:
                trace.record(False)
            line = dict(seed=seed, record=on, correct=res["correct"], failed=res["failed"],
                        kmer_rate=res["metrics"]["kmer_rate"]["value"],
                        records=len(trace.records()))
            trace.clear()
            print(json.dumps(line), flush=True)
            runs[on].append(line["kmer_rate"])
    return dict(workload=cell["name"], seeds=list(seeds),
                off=dict(median=statistics.median(runs[0]), spread=spread(runs[0]), runs=runs[0]),
                on=dict(median=statistics.median(runs[1]), spread=spread(runs[1]), runs=runs[1]),
                on_over_off=statistics.median(runs[1]) / statistics.median(runs[0]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("split", "cost"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    from kbench import run

    cell = run.load_cell(a.workload)
    if a.mode == "split":
        res = split(cell, a.seed, a.seconds, a.out)
    else:
        res = cost(cell, [int(s) for s in a.seeds.split(",")], a.seconds)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
