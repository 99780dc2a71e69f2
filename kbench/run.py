#!/usr/bin/env python3
"""kbench: the benchmark of kaarme_tpu_torch, the PyTorch + CUDA port.

    python3 kbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cell's cards.  A
cell of ``BENCHMARK.json`` names a configuration (``kbench/configs/``:
the CLI's flags, the input's sizes, its plain reference under
``kbench/reference/``) and a traffic mix (``kbench/traffic/<mix>.json``,
read by the one generator ``kbench/gen.py``).

- Set-up (``setup_s``, from the start of this script): imports, the
  input FASTA made from ``--seed`` in a fresh directory under TMPDIR,
  and one warm-up job (the first run in a checkout builds the port's
  kernel and host libraries into ``build/kaarme_tpu_torch/`` there).
- The window: whole jobs back to back, each one call of the port's entry
  point ``kaarme_tpu_torch.cli.run`` on the input (read, encode, count,
  write the count file), until ``--seconds`` have passed; the last job
  to start finishes.  Every job but the last writes its count file to
  ``os.devnull``; the last writes it under TMPDIR, and that file and that
  job's store are what ``kbench/judge.py`` holds to the reference, after
  the window, the peak memory reading and the program's state freed.
- The cell's cards are cuda:0 .. cuda:chips-1.  Every card is
  synchronised after the warm-up, around the trace's anchor and at the
  window's end.  Each card's peak of allocated memory is reset after the
  warm-up and read after the window: ``peak_mem_bytes`` is the fullest
  card's window peak, ``device.memory_peak_bytes`` the fullest card's
  peak over set-up and window, ``device.memory_peak_bytes_per_card``
  each card's.
- The judge works in key-hash parts, one a card: the store's live rows
  are copied out of each dump part on its own card and sent, block by
  block, to their part's card; part p of the reference is counted on
  card p; the parts are compared one after another.  Its seconds and
  each card's peak over it go to standard error (``judge seconds:``).
- ``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs
  the window under ``torch.profiler`` with the harness's spans
  (``kbench/trace.py``: busy and idle time card by card, averaged over
  the cell's cards) and prints its per-layer metrics, each read by
  ``kbench/metrics/<name>.py``.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and the compared
numbers with their limits under ``checks``, last); the compared numbers
are also the last lines of standard error.  Without a CUDA card, or with
fewer than the cell asks for, it exits 2 and prints no result; if JAX or
the JAX package was imported, it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "kaarme_tpu")


def forbidden_modules() -> list:
    """Top-level names (the part before the first dot, compared whole)
    of loaded modules that this process must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(name=name, chips=cell["chips"], config=config,
                params={**config["input"], **{k: v for k, v in traffic.items() if k not in ("why", "source")}},
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def reader(name: str):
    """The per-layer metric reader ``kbench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"kbench.metrics.{name}", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _job(cli, argv, spans):
    """One job: (exit code, counter or None); an exception is a failure."""
    try:
        with spans.span("job") if spans else contextlib.nullcontext():
            return cli.run(argv)
    except Exception:          # a job that raises is a failed job, reported
        traceback.print_exc()
        return 1, None


def cards(chips: int, device: str = "cuda") -> list:
    """The cell's cards: cuda:0 .. cuda:chips-1; off the card, the one
    device once a card (tests)."""
    import torch

    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(device)] * chips


def synchronize(devs):
    """Wait for the work queued on every card of ``devs``."""
    import torch

    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def reset_peaks(devs):
    import torch

    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def peaks(devs) -> list:
    """Each card's peak of allocated bytes since its last reset (0 off
    the card)."""
    import torch

    return [torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0 for d in devs]


def into_parts(keys, counts, devs, parts=None) -> list:
    """Rows (the reference's key rows) and their counts split into
    key-hash parts, one part a device of ``devs``: part p's rows copied
    to ``devs[p]`` and appended to ``parts[p]`` ([key blocks], [count
    blocks]; new lists when None).  Returns ``parts``."""
    import torch

    from kbench.reference import kmer_count as ref

    parts = parts or [([], []) for _ in devs]
    part = ref.part_of(keys, len(devs))
    for p, dev in enumerate(devs):
        sel = torch.nonzero(part == p).flatten()
        parts[p][0].append(keys.index_select(0, sel).to(dev))
        parts[p][1].append(counts.index_select(0, sel).to(dev))
    return parts


def joined(parts) -> list:
    """Each part's blocks joined on its own device: [(keys, counts)]."""
    import torch

    return [(torch.cat(kk), torch.cat(cc)) for kk, cc in parts]


def _live_rows(counter, k: int, devs) -> list:
    """The live rows (count > 0) of a counter's dump parts, copied out of
    its state as the reference's key rows, in key-hash parts: part p's
    (keys, counts) on ``devs[p]``.  Each dump part is read on the card it
    lies on, ``ROWS`` rows at a time, and each block's rows go to their
    part's card: nothing is joined across cards."""
    import torch

    from kbench import judge
    from kbench.reference import kmer_count as ref

    parts = [([torch.zeros((0, ref.key_words(k)), dtype=torch.int64, device=d)],
              [torch.zeros(0, dtype=torch.int64, device=d)]) for d in devs]
    for keys, cnt in (counter.dump_columns() if counter is not None else []):
        for r0 in range(0, cnt.shape[0], ref.ROWS):
            c = cnt[r0:r0 + ref.ROWS]
            live = torch.nonzero(c > 0).flatten()
            rows = judge.store_keys([col[r0:r0 + ref.ROWS].index_select(0, live) for col in keys], k)
            into_parts(rows, c.index_select(0, live), devs, parts)
    return joined(parts)


def judged_outputs(counter, counts_path: str, k: int, devs):
    """The judged job's store (its live rows in key-hash parts, one a
    device of ``devs``) and count file (bytes, then removed); empty where
    the job left none."""
    store = _live_rows(counter, k, devs)
    text = b""
    if os.path.exists(counts_path):
        with open(counts_path, "rb") as f:
            text = f.read()
        os.remove(counts_path)
    return store, text


def reference_parts(cfg: dict, inp: dict, devs):
    """The configuration's plain reference on the input in key-hash
    parts: part p's (keys, counts) on ``devs[p]``, each counted when it
    is drawn."""
    refmod = importlib.import_module(f"kbench.reference.{cfg['reference']}")
    for p, dev in enumerate(devs):
        yield refmod.count_part(inp["path"], cfg["k"], dev, p, len(devs))


def compare(cfg: dict, inp: dict, reference, store: list, text: bytes, jobs_failed: int) -> dict:
    """The judge on the reference's parts (``reference``, drawn one at a
    time) and the store's (``store``, each part dropped from the list
    once judged): the compared numbers with their limits."""
    from kbench import judge

    def parts():
        for p, rows in enumerate(reference):
            yield (*rows, *store[p])
            del rows
            store[p] = None

    checks, info = judge.judge(cfg["k"], cfg["flags"], parts(), text, jobs_failed)
    windows = info.pop("reference_windows")
    if windows != inp["valid_windows"]:
        raise RuntimeError(f"the reference counted {windows} windows, the "
                           f"generator made {inp['valid_windows']}")
    for key, v in info.items():
        print(f"{key}: {v}", file=sys.stderr)
    return checks


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, parts: int = None) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``device="cpu"`` runs the port's plain versions on the CPU (tests).
    The judge counts and compares in ``parts`` key-hash parts, one a card
    of the cell (the default), the cards taken in turn where there are
    more parts than cards."""
    import torch

    from kaarme_tpu_torch import cli

    from kbench import gen, judge
    from kbench import trace as tr

    t_start = T_START if t_start is None else t_start
    cfg = cell["config"]
    k = cfg["k"]
    cuda = device == "cuda"
    devs = cards(cell["chips"], device)
    judge_devs = [devs[p % len(devs)] for p in range(parts or len(devs))]
    work = tempfile.mkdtemp(prefix="kbench-")
    spans = tr.Spans().install() if trace else None
    prof = None
    try:
        t_imports = time.perf_counter()
        inp = gen.write_input(os.path.join(work, "reads.fa"), cell["params"], seed, k)
        t_input = time.perf_counter()
        counts_path = os.path.join(work, "reads.kaarme_counts")

        def argv(out):
            return [inp["path"], str(k), *cfg["flags"], "-o", out, "--device", device]

        rc, counter = _job(cli, argv(os.devnull), spans)
        if rc:
            raise RuntimeError(f"the warm-up job exited {rc}")
        del counter
        synchronize(devs)
        setup_peaks = peaks(devs)
        reset_peaks(devs)
        if trace:
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
            prof.__enter__()
            synchronize(devs)
            # the anchor: the trace's first device operation, on every card
            # (a card's anchor is its first operation in the trace)
            anchor_ns = time.perf_counter_ns()
            if cuda:
                for d in devs:
                    torch.zeros(1, device=d)
                synchronize(devs)
        setup_s = time.perf_counter() - t_start
        print(f"setup seconds: imports {t_imports - t_start:.4f} input {t_input - t_imports:.4f} "
              f"warm-up {setup_s - (t_input - t_start):.4f}", file=sys.stderr)

        # the window: whole jobs; the job expected to end past --seconds
        # (at the mean job time so far) is the last, and writes its file
        jobs, failed, judged_counter = [], 0, None
        w0 = time.perf_counter_ns()
        while True:
            t = time.perf_counter_ns()
            last = bool(jobs) and (t - w0) / 1e9 + (t - w0) / 1e9 / len(jobs) >= seconds
            rc, counter = _job(cli, argv(counts_path if last else os.devnull), spans)
            jobs.append((time.perf_counter_ns() - t) / 1e9)
            if rc or counter is None:
                failed += 1
            else:
                jobs[-1] = dict(seconds=jobs[-1], stats=dict(counter.stats))
            if last:
                judged_counter, counter = counter, None
                break
            del counter
        w1 = time.perf_counter_ns()
        print("job seconds: " + " ".join(f"{j['seconds'] if isinstance(j, dict) else j:.4f}"
                                         for j in jobs), file=sys.stderr)
        synchronize(devs)
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peaks = peaks(devs)

        # the judged job's outputs, copied out; then the program's state goes
        reset_peaks(devs)
        t_judge = time.perf_counter()
        store, text = judged_outputs(judged_counter, counts_path, k, judge_devs)
        del judged_counter
        gc.collect()                       # a cycle in the program's state would keep it
        judge_s = time.perf_counter() - t_judge
        ok_jobs = [j for j in jobs if isinstance(j, dict)]
        rec = dict(k=k, jobs=ok_jobs, input=inp, trace=None,
                   judged=dict(store_rows=sum(int(c.shape[0]) for _, c in store),
                               key_words=-(-k // 16), text_bytes=len(text)))
        metrics = {}
        if trace:
            rec["trace"] = tr.device_summary(tr.profiler_events(prof), spans, anchor_ns, w0, w1)
            for m in cell["per_layer"]:
                v = reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = dict(kmer_rate=len(ok_jobs) * inp["valid_windows"] / ((w1 - w0) / 1e9),
                       peak_mem_bytes=max(window_peaks) if cuda else None, setup_s=setup_s)
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

        t_judge = time.perf_counter()
        checks = compare(cfg, inp, reference_parts(cfg, inp, judge_devs), store, text, failed)
        judge_s += time.perf_counter() - t_judge
        print(f"judge seconds: {judge_s:.4f} parts {len(judge_devs)} peak bytes by card: "
              + " ".join(str(b) for b in peaks(devs)), file=sys.stderr)
        correct = judge.ok(checks)
        if not correct and failed == 0:
            failed = 1                     # the judged job failed the comparison
        per_card = [max(a, b) for a, b in zip(setup_peaks, window_peaks)]
        out = dict(correct=correct, attempted=len(jobs), failed=failed, metrics=metrics,
                   device=dict(platform="gpu" if cuda else "cpu",
                               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                               count=cell["chips"], memory_peak_bytes=max(per_card),
                               memory_peak_bytes_per_card=per_card))
        if rec["trace"]:
            out["device"].update({key: rec["trace"][key]
                                  for key in ("busy_s", "window_s", "busy_s_per_card")})
            out["breakdown"] = {key: rec["trace"][key] for key in ("device_ops", "idle_gaps")}
        out["checks"] = checks
        return out
    finally:
        if spans is not None:
            spans.uninstall()
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"error: {a.workload} needs {cell['chips']} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for name, d in res["checks"].items():
        print(f"{name} {d['value']} limit {d['limit']}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
