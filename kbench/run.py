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
- ``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs
  the window under ``torch.profiler`` with the harness's spans
  (``kbench/trace.py``) and prints its per-layer metrics, each read by
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


def _live_rows(counter):
    """The live rows (count > 0) of a counter's dump parts, copied out of
    its state: (key columns, counts)."""
    import torch

    cols, cnts = [], []
    for keys, cnt in counter.dump_columns():
        live = torch.nonzero(cnt > 0).flatten()
        cols.append([c.index_select(0, live) for c in keys])
        cnts.append(cnt.index_select(0, live))
    return [torch.cat(c) for c in zip(*cols)], torch.cat(cnts)


def judged_outputs(counter, counts_path: str, k: int, dev):
    """The judged job's store (live rows as the reference's key rows, and
    counts) and count file (bytes, then removed); empty where the job
    left none."""
    import torch

    from kbench import judge

    if counter is not None:
        cols, counts = _live_rows(counter)
    else:
        cols = [torch.zeros(0, dtype=torch.int32, device=dev)] * -(-k // 16)
        counts = torch.zeros(0, dtype=torch.int64, device=dev)
    text = b""
    if os.path.exists(counts_path):
        with open(counts_path, "rb") as f:
            text = f.read()
        os.remove(counts_path)
    return judge.store_keys(cols, k), counts, text


def reference_rows(cfg: dict, inp: dict, dev) -> tuple:
    """The configuration's plain reference on the input: (keys, counts)."""
    refmod = importlib.import_module(f"kbench.reference.{cfg['reference']}")
    _, keys, counts = refmod.count_file(inp["path"], cfg["k"], dev)
    if int(counts.sum()) != inp["valid_windows"]:
        raise RuntimeError(f"the reference counted {int(counts.sum())} windows, the "
                           f"generator made {inp['valid_windows']}")
    return keys, counts


def compare(cfg: dict, rows: tuple, keys, counts, text: bytes, jobs_failed: int) -> dict:
    """The judge on the reference's ``rows``: the compared numbers with
    their limits."""
    from kbench import judge

    checks, info = judge.judge(cfg["k"], cfg["flags"], *rows, keys, counts, text, jobs_failed)
    for key, v in info.items():
        print(f"{key}: {v}", file=sys.stderr)
    return checks


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``device="cpu"`` runs the port's plain versions on the CPU (tests)."""
    import torch

    from kaarme_tpu_torch import cli

    from kbench import gen, judge
    from kbench import trace as tr

    t_start = T_START if t_start is None else t_start
    cfg = cell["config"]
    k = cfg["k"]
    cuda = device == "cuda"
    dev = torch.device(device)
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
        setup_peak = 0
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if trace:
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
            prof.__enter__()
            if cuda:                       # the anchor: the trace's first device operation
                torch.cuda.synchronize()
            anchor_ns = time.perf_counter_ns()
            if cuda:
                torch.zeros(1, device=dev)
                torch.cuda.synchronize()
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
        if cuda:
            torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0

        # the judged job's outputs, copied out; then the program's state goes
        skeys, scounts, text = judged_outputs(judged_counter, counts_path, k, dev)
        del judged_counter
        ok_jobs = [j for j in jobs if isinstance(j, dict)]
        rec = dict(k=k, jobs=ok_jobs, input=inp, trace=None,
                   judged=dict(store_rows=int(scounts.shape[0]), key_words=-(-k // 16),
                               text_bytes=len(text)))
        metrics = {}
        if trace:
            rec["trace"] = tr.device_summary(tr.profiler_events(prof), spans, anchor_ns, w0, w1)
            for m in cell["per_layer"]:
                v = reader(m["name"])(rec)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = dict(kmer_rate=len(ok_jobs) * inp["valid_windows"] / ((w1 - w0) / 1e9),
                       peak_mem_bytes=window_peak if cuda else None, setup_s=setup_s)
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

        checks = compare(cfg, reference_rows(cfg, inp, dev), skeys, scounts, text, failed)
        correct = judge.ok(checks)
        if not correct and failed == 0:
            failed = 1                     # the judged job failed the comparison
        out = dict(correct=correct, attempted=len(jobs), failed=failed, metrics=metrics,
                   device=dict(platform="gpu" if cuda else "cpu",
                               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                               count=cell["chips"],
                               memory_peak_bytes=max(setup_peak, window_peak)))
        if rec["trace"]:
            out["device"].update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
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
