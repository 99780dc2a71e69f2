"""The port's tracer (``kaarme_tpu_torch/utils/trace.py``): spans and
counters, their per-job totals in a counter's ``stats``, the records kept
while recording, the CLI's ``--trace-out`` Chrome trace, and the records
read by the benchmark's device summary.  The last test runs on a card
only: every call that blocks the host on the card is a counted site."""

import glob
import json
import os
import re
import threading
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

from kaarme_tpu_torch import cli
from kaarme_tpu_torch.models import bloom_counter, counter
from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu_torch.models.sort_counter import SortCounterConfig, SortKmerCounter
from kaarme_tpu_torch.ops import skm
from kaarme_tpu_torch.utils import trace

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "kaarme_tpu_torch")
MAIN_SPANS = {"reader_wait", "pack_wait", "to_device", "dispatch", "drain", "replay"}


@pytest.fixture
def rec():
    """Recording on, from an empty buffer; off and empty afterwards."""
    trace.clear()
    was = trace.record(True)
    yield
    trace.record(was)
    trace.clear()


def _reads(n_reads=400, seed=3, err=0.02):
    """Reads of a small random genome (the second strand included), with
    substitutions: repeated and singleton k-mers alike."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for _ in range(n_reads):
        s = int(rng.integers(0, genome.shape[0] - 100))
        r = genome[s:s + 100].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        flip = rng.random(100) < err
        r[flip] = (r[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
        out.append(r)
    return out


def _fasta(path, reads):
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n" % i + np.frombuffer(b"ACGT", np.uint8)[r].tobytes() + b"\n")
    return str(path)


def _codes(reads):
    return np.concatenate([np.append(r, 4).astype(np.uint8) for r in reads])


def _small_skm(**kw):
    return SkmCounterConfig(k=31, min_abundance=1, device="cpu", batch_windows=1 << 12,
                            superbatch_batches=2, prefix_cap=1 << 12, **kw)


def _totals(recs):
    out = {}
    for name, _, t0, t1, _ in recs:
        out[trace.key(name)] = out.get(trace.key(name), 0.0) + (t1 - t0) / 1e9
    return out


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


# -- spans ---------------------------------------------------------------------


def test_spans_nest_and_self_times_add_back_up_to_the_parent(rec):
    stats = {}
    with trace.span("outer", stats):
        time.sleep(0.002)
        with trace.span("a"):
            time.sleep(0.002)
            with trace.span("a1"):
                time.sleep(0.001)
        with trace.span("b"):
            time.sleep(0.001)
        trace.count("events", 3)
    recs = trace.records()
    by = {r[0]: r for r in recs}
    assert [r[0] for r in recs] == ["a1", "a", "b", "outer"]       # in the order they ended
    assert by["outer"][4] is None and by["a"][4] == by["b"][4] == "outer"
    assert by["a1"][4] == "a"
    assert all(_inside(by[n], by["outer"]) for n in ("a", "a1", "b"))
    assert _inside(by["a1"], by["a"])
    self_ns = dict(zip([r[0] for r in recs], trace.self_ns(recs)))
    dur = {r[0]: r[3] - r[2] for r in recs}
    assert self_ns["a1"] == dur["a1"] and self_ns["b"] == dur["b"]
    assert self_ns["a"] == dur["a"] - dur["a1"]
    assert self_ns["outer"] == dur["outer"] - dur["a"] - dur["b"]
    assert sum(self_ns.values()) == dur["outer"]
    assert all(v > 0 for v in self_ns.values())
    # totals: the span bound ``stats``, so the inner spans and the counter landed there
    assert stats["outer_seconds"] == pytest.approx(dur["outer"] / 1e9)
    assert stats["a_seconds"] == pytest.approx(dur["a"] / 1e9)
    assert stats["events"] == 3
    assert trace.counter_records()[0][0] == "events" and trace.counter_records()[0][3] == 3


def test_a_span_records_its_seconds_and_keys():
    with trace.span("x") as sp:
        pass
    assert sp.seconds is not None and sp.seconds >= 0
    assert trace.key("count") == "build_seconds" and trace.key("write") == "write_seconds"
    assert trace.key("reader_wait") == "reader_wait_seconds"


def test_unbound_spans_add_to_no_dict_and_counters_count_loose(rec):
    with trace.span("free"):
        trace.count("loose", 2)
    trace.count("loose")
    assert [r[0] for r in trace.records()] == ["free"]
    assert [c[3] for c in trace.counter_records()] == [2, 3]


@pytest.mark.parametrize("route", ["skm", "skm_bloom", "classic", "table", "table_bloom"])
def test_stats_totals_equal_the_span_sums(tmp_path, rec, route):
    path = _fasta(tmp_path / "r.fa", _reads())
    if route == "skm":
        c = SkmCounter(_small_skm()).count_file(path)
    elif route == "skm_bloom":
        c = bloom_counter.BloomSkmCounter(_small_skm(), 4000).count_file_two_pass(path)
    elif route == "classic":
        c = SortKmerCounter(SortCounterConfig(k=13, min_abundance=1, device="cpu",
                                              batch_windows=1 << 12, superbatch_batches=2,
                                              prefix_cap=1 << 12)).count_file(path)
    elif route == "table":
        c = counter.KmerCounter(counter.CounterConfig(k=31, min_slots=256, tile=256,
                                                      batch_tiles=4, device="cpu",
                                                      min_abundance=1)).count_file(path)
    else:
        c = bloom_counter.bloom_count_file(bloom_counter.BloomCounterConfig(
            k=31, expected_unique=4000, tile=256, batch_tiles=4, device="cpu"), path)
    c.write_output(str(tmp_path / "out.txt"))
    got = _totals(trace.records())
    for key, v in got.items():
        if key != "kernel_build_seconds":
            assert c.stats[key] == pytest.approx(v, rel=1e-9, abs=1e-9), key
    want = {"count", "write", "reader_wait", "read", "encode", "pack", "to_device", "dispatch",
            "drain", "format", "file_write"}
    if route.startswith("skm"):
        want |= {"finalize", "expand", "pack_wait"}
    if route.endswith("bloom"):
        want.add("bloom_pass1")
    assert want <= {r[0] for r in trace.records()}
    assert c.stats["host_syncs"] >= 1
    if route == "table":
        assert c.stats["grow_events"] >= 1 and "replay" in {r[0] for r in trace.records()}


def test_recording_off_keeps_no_records_and_the_same_totals(tmp_path):
    path = _fasta(tmp_path / "r.fa", _reads())
    trace.clear()
    assert not trace.recording()
    c = SkmCounter(_small_skm()).count_file(path)
    c.write_output(str(tmp_path / "out.txt"))
    assert trace.records() == [] and trace.counter_records() == []
    for key in ("build_seconds", "reader_wait_seconds", "pack_seconds", "pack_wait_seconds",
                "to_device_seconds", "dispatch_seconds", "drain_seconds", "write_seconds",
                "finalize_seconds", "format_seconds", "file_write_seconds", "read_seconds",
                "encode_seconds"):
        assert c.stats[key] > 0, key
    assert c.stats["write_seconds"] >= c.stats["finalize_seconds"] + c.stats["format_seconds"]
    assert c.stats["host_syncs"] >= 2 and c.stats["finalize_chunks"] == 1


def test_reader_and_pack_spans_run_on_their_own_threads(tmp_path, rec):
    path = _fasta(tmp_path / "r.fa", _reads(n_reads=1500))
    main = threading.get_ident()
    SkmCounter(_small_skm()).count_file(path, chunk_bytes=1 << 13)
    threads = {}
    for name, tid, *_ in trace.records():
        threads.setdefault(name, set()).add(tid)
    assert len(threads["read"]) == 1 and threads["read"] == threads["encode"]
    assert len(threads["pack"]) == 1
    reader_t, pack_t = next(iter(threads["read"])), next(iter(threads["pack"]))
    assert len({main, reader_t, pack_t}) == 3
    for name in MAIN_SPANS & set(threads):
        assert threads[name] == {main}, name
    n_chunks = sum(1 for r in trace.records() if r[0] == "encode")
    assert n_chunks > 4
    # the main thread's wait covers every chunk and the end of the stream
    assert sum(1 for r in trace.records() if r[0] == "reader_wait") == n_chunks + 1


def test_count_spans_the_whole_count_file_and_pass1_its_extent(tmp_path, rec):
    path = _fasta(tmp_path / "r.fa", _reads())
    c = bloom_counter.BloomSkmCounter(_small_skm(), 4000)
    t0 = time.perf_counter_ns()
    c.count_file_two_pass(path)
    t1 = time.perf_counter_ns()
    main = threading.get_ident()
    recs = [r for r in trace.records() if r[1] == main]
    (p1,) = [r for r in recs if r[0] == "bloom_pass1"]
    (cnt,) = [r for r in recs if r[0] == "count"]
    assert t0 <= p1[2] and p1[3] <= cnt[2] and cnt[3] <= t1
    assert c.stats["bloom_pass1_seconds"] == pytest.approx((p1[3] - p1[2]) / 1e9)
    assert c.stats["build_seconds"] == pytest.approx((cnt[3] - cnt[2]) / 1e9)
    # every main-thread span of either pass lies in one of the two; the
    # read of B1's counters (a drain) ends pass 1
    rest = [r for r in recs if r[0] not in ("bloom_pass1", "count")]
    assert rest and all(_inside(r, p1) or _inside(r, cnt) for r in rest)
    last_p1 = max((r for r in rest if _inside(r, p1)), key=lambda r: r[3])
    assert last_p1[0] == "drain" and last_p1[4] == "bloom_pass1"
    assert sum(_inside(r, p1) for r in rest if r[0] == "reader_wait") > 0
    assert sum(_inside(r, cnt) for r in rest if r[0] == "reader_wait") > 0


@pytest.mark.parametrize("route", ["sort", "table"])
def test_build_seconds_is_the_whole_count_on_every_backend(tmp_path, rec, route):
    path = _fasta(tmp_path / "r.fa", _reads())
    if route == "sort":
        c = SkmCounter(_small_skm())
    else:
        c = counter.KmerCounter(counter.CounterConfig(k=31, min_slots=256, tile=256,
                                                      batch_tiles=4, device="cpu"))
    t0 = time.perf_counter_ns()
    c.count_file(path)
    t1 = time.perf_counter_ns()
    (cnt,) = [r for r in trace.records() if r[0] == "count"]
    inner = [r for r in trace.records() if r[0] in MAIN_SPANS]
    assert inner and all(_inside(r, cnt) for r in inner)
    assert t0 <= cnt[2] and cnt[3] <= t1
    assert c.stats["build_seconds"] == pytest.approx((cnt[3] - cnt[2]) / 1e9)
    assert c.stats["build_seconds"] > c.stats["dispatch_seconds"]


def test_replays_nest_under_drain_and_count_their_dispatches(rec):
    codes = _codes(_reads(n_reads=1500, err=0.05))
    c = SkmCounter(_small_skm(segpack="slotted", skm_slots=2)).count_codes(codes)
    assert c.stats["slot_grow_events"] >= 1 and c.stats["replayed_supersteps"] >= 1
    recs = trace.records()
    replays = [r for r in recs if r[0] == "replay"]
    assert replays and all(r[4] == "drain" for r in replays)
    in_replay = [r for r in recs if r[0] == "dispatch" and r[4] == "replay"]
    assert len(in_replay) == c.stats["replayed_supersteps"]
    assert sum(r[0] == "dispatch" for r in recs) == c.stats["batches"] + len(in_replay)
    names = {r[0] for r in trace.counter_records()}
    assert {"batches", "compactions", "host_syncs", "replayed_supersteps",
            "slot_grow_events"} <= names


@pytest.mark.parametrize("chunk_rows,acc", [(64, "grows"), (1 << 20, "single")])
def test_finalize_counts_its_chunks_regrows_and_syncs(chunk_rows, acc, rec):
    c = SkmCounter(_small_skm()).count_codes(_codes(_reads(n_reads=800)))
    run_cols = tuple(col[: c.n_used] for col in c.prefix)
    stats = {}
    with trace.span("finalize", stats):
        store, nd = skm.finalize_store(run_cols, 31, chunk_rows=chunk_rows,
                                       single_shot_rows=0 if acc == "grows" else None)
    expand = [r for r in trace.records() if r[0] == "expand"]
    want, want_nd = c.finalize_device()
    assert nd == want_nd
    assert all(torch.equal(a[:nd], b[:nd]) for a, b in zip(store, want))
    if acc == "single":
        assert stats["finalize_chunks"] == 1 and "finalize_regrows" not in stats
    else:
        chunks = -(-c.n_used // chunk_rows)
        assert stats["finalize_regrows"] >= 1
        assert stats["finalize_chunks"] == chunks + stats["finalize_regrows"]
    assert stats["host_syncs"] == stats["finalize_chunks"]
    # one expansion span a chunk attempt, inside the finalize
    assert len(expand) == stats["finalize_chunks"] and {r[4] for r in expand} == {"finalize"}
    assert 0 < stats["expand_seconds"] <= stats["finalize_seconds"]


def test_kernel_build_and_the_counters_are_spans_of_the_tracer():
    """No perf_counter pair feeds a stats entry in the port: every timer
    is a span of the tracer, and every stats counter of the list below
    is counted by it."""
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        if path.endswith(os.path.join("utils", "trace.py")):
            continue
        with open(path) as f:
            text = f.read()
        assert not re.search(r"perf_counter(_ns)?\(", text), path
        assert not re.search(r'stats\["(batches|compactions|grow_events|replayed_supersteps|'
                             r'slot_grow_events|host_syncs)"\] \+=', text), path
    with open(os.path.join(PKG, "ops", "_build.py")) as f:
        assert 'trace.span("kernel_build")' in f.read()


# -- the CLI's Chrome trace ----------------------------------------------------------


def _check_chrome(obj):
    """Chrome trace-event JSON as Perfetto reads it: a traceEvents list,
    "X" events with numeric ts and dur that nest on each track, "C"
    events with one numeric value, "M" metadata naming each track."""
    assert isinstance(obj["traceEvents"], list)
    json.loads(json.dumps(obj))
    names, per_track = {}, {}
    for e in obj["traceEvents"]:
        assert e["ph"] in ("X", "C", "M") and isinstance(e["pid"], int)
        assert isinstance(e["tid"], int) and 0 <= e["tid"] < 2 ** 31
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                names[e["tid"]] = e["args"]["name"]
            continue
        assert isinstance(e["ts"], float) and isinstance(e["name"], str)
        if e["ph"] == "X":
            assert e["dur"] >= 0
            per_track.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e))
        else:
            (v,) = e["args"].values()
            assert isinstance(v, (int, float))
    for tid, evs in per_track.items():
        assert tid in names
        stack = []
        for t0, t1, e in sorted(evs, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= t0:
                stack.pop()
            assert not stack or t1 <= stack[-1][1] + 1e-3, (e, stack[-1])
            assert e["args"]["parent"] == (stack[-1][2]["name"] if stack else None)
            stack.append((t0, t1, e))
    return names, per_track


@pytest.mark.parametrize("extra", [[], ["-b", "-u", "4000"]], ids=["skm", "skm_bloom"])
def test_cli_trace_out_writes_a_chrome_trace_with_the_stats_totals(tmp_path, extra):
    path = _fasta(tmp_path / "r.fa", _reads())
    out = tmp_path / "t.json"
    sizing = [] if extra else ["-s", "5000"]
    rc, c = cli.run([path, "31", "--device", "cpu", "--kernels", "plain", "-q", "-a", "1",
                     "-o", str(tmp_path / "c.txt"), "--trace-out", str(out), *sizing, *extra])
    assert rc == 0 and not trace.recording() and os.path.getsize(tmp_path / "c.txt") > 0
    obj = json.loads(out.read_text())
    names, per_track = _check_chrome(obj)
    assert len(per_track) >= 3 and len(names) == len(per_track)   # main, reader, pack worker
    tot = {}
    for e in obj["traceEvents"]:
        if e["ph"] == "X":
            tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
    assert tot["count"] == pytest.approx(c.stats["build_seconds"], rel=1e-6)
    assert tot["write"] == pytest.approx(c.stats["write_seconds"], rel=1e-6)
    if extra:
        assert tot["bloom_pass1"] == pytest.approx(c.stats["bloom_pass1_seconds"], rel=1e-6)
    counters = {e["name"] for e in obj["traceEvents"] if e["ph"] == "C"}
    assert {"batches", "compactions", "host_syncs", "finalize_chunks"} <= counters
    last = [e for e in obj["traceEvents"] if e["ph"] == "C" and e["name"] == "host_syncs"][-1]
    assert last["args"]["host_syncs"] == c.stats["host_syncs"]


def test_cli_without_trace_out_records_nothing(tmp_path, capsys):
    path = _fasta(tmp_path / "r.fa", _reads())
    trace.clear()
    rc, c = cli.run([path, "31", "--device", "cpu", "-s", "5000", "-o",
                     str(tmp_path / "c.txt")])
    assert rc == 0 and trace.records() == []
    printed = capsys.readouterr().out
    us = int(re.search(r"hash table construction: (\d+) microseconds", printed).group(1))
    assert us == round(c.stats["build_seconds"] * 1e6)


# -- the benchmark's device summary on the program's records --------------------------


def test_device_summary_names_idle_gaps_by_the_innermost_program_span(rec):
    from kbench import trace as bench_trace

    main = threading.get_ident()
    recs = [("count", main, 1_000_000, 8_000_000, None),
            ("reader_wait", main, 1_000_000, 2_000_000, "count"),
            ("dispatch", main, 3_000_000, 4_000_000, "count"),
            ("drain", main, 5_000_000, 7_000_000, "count"),
            ("pack", main + 1, 0, 9_000_000, None)]       # another thread: never names a gap
    view = trace.program_spans(recs)
    assert view.main == main and view.records[0] == ("count", main, 1_000_000, 8_000_000)
    a = 5_000.0 - 0.5

    def us(ns):
        return a + ns / 1e3

    ev = [("kernel", "anchor", us(500), us(1_500)),
          ("kernel", "k", us(2_000_000), us(3_500_000)),
          ("kernel", "k", us(6_000_000), us(7_000_000))]
    s = bench_trace.device_summary(ev, view, 500, 0, 10_000_000)
    gaps = dict(s["idle_gaps"])
    assert gaps["reader_wait"] == pytest.approx(0.001)     # 1-2 ms
    assert gaps["dispatch"] == pytest.approx(0.0005)       # 3.5-4 ms
    assert gaps["count"] == pytest.approx(0.002)           # 4-5 ms and 7-8 ms
    assert gaps["drain"] == pytest.approx(0.001)           # 5-6 ms
    assert gaps["harness"] == pytest.approx(0.003 - 1e-6)  # outside the count
    assert "pack" not in gaps
    # the live records serve as well: a real span becomes a named gap
    with trace.span("format"):
        t0 = time.perf_counter_ns()
        time.sleep(0.003)
    t1 = time.perf_counter_ns()
    live = trace.program_spans()
    (fmt,) = [r for r in live.records if r[0] == "format"]
    s = bench_trace.device_summary([("kernel", "anchor", 0.0, 1.0)], live, t0 - 2_000, t0, t1)
    assert dict(s["idle_gaps"])["format"] == pytest.approx((fmt[3] - t0) / 1e9, abs=1e-8)
    assert dict(s["idle_gaps"])["harness"] == pytest.approx((t1 - fmt[3]) / 1e9, abs=1e-8)


# -- on a card: every synchronising call is a counted host_syncs site ---------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the synchronising calls happen only on a card")
    return torch.device("cuda")


def _sync_sites(fn):
    """(file, line) in the port of each call that torch's sync debug mode
    names while ``fn`` runs: the innermost frame of the port's package on
    the warning's stack.  Other warnings (such as the one that the first
    ``set_sync_debug_mode`` of a process gives) are left out."""
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()
        mine = [f for f in stack if f.filename.startswith(PKG)]
        sites.append((mine[-1].filename, mine[-1].lineno) if mine else (filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def _counted(site) -> bool:
    """A counted site: ``host_syncs`` is counted on the line or on one of
    the three lines before it."""
    path, line = site
    if not path.startswith(PKG):
        return False
    with open(path) as f:
        lines = f.read().splitlines()
    return any("host_syncs" in ln for ln in lines[max(line - 4, 0):line])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["-b", "-u", "40000"]], ids=["skm", "skm_bloom"])
def test_every_sync_on_a_card_is_a_counted_host_sync(tmp_path, card, extra):
    path = _fasta(tmp_path / "r.fa", _reads(n_reads=4000))
    argv = [path, "51", "-q", "-a", "2", "-o", str(tmp_path / "c.txt"), *extra]
    if not extra:
        argv += ["-s", "20000"]
    rc, _ = cli.run(argv)                      # builds the kernels outside the check
    assert rc == 0
    got = {}

    def job():
        got["rc"], got["c"] = cli.run(argv)

    sites = _sync_sites(job)
    assert got["rc"] == 0 and sites, "sync debug mode named no call"
    bad = sorted({s for s in sites if not _counted(s)})
    assert not bad, bad
    assert got["c"].stats["host_syncs"] >= len(sites)
