"""Each per-layer metric reader, and the trace reading, on made-up records."""

import threading

import pytest

from kbench import roofline, run
from kbench import trace as tr

JOBS = [dict(seconds=1.0, stats=dict(build_seconds=0.5, write_seconds=0.2, replayed_supersteps=2,
                                      slot_grow_events=1, bloom_pass1_seconds=0.4)),
        dict(seconds=1.2, stats=dict(build_seconds=0.7, write_seconds=0.4, replayed_supersteps=0,
                                      slot_grow_events=1, bloom_pass1_seconds=0.6))]
TRACE = dict(busy_s=2.0, window_s=10.0, kernel_s=0.5, device_ops=[], idle_gaps=[])


def rec(**kw):
    base = dict(k=51, jobs=JOBS, trace=TRACE,
                input=dict(path="", codes=4_000_000, valid_windows=10),
                judged=dict(store_rows=1_000_000, key_words=4, text_bytes=55_000_000))
    return {**base, **kw}


@pytest.mark.parametrize("name,want", [
    ("count_s", 0.6), ("write_s", 0.3), ("replays_per_job", 2.0), ("bloom_pass1_s", 0.5),
    ("device_idle_pct", 80.0),
])
def test_readers_on_a_record(name, want):
    assert run.reader(name)(rec()) == pytest.approx(want)


def test_kernels_roofline_is_least_time_over_kernel_time():
    nbytes = 1_000_000 + 1_000_000 * 20 + 55_000_000
    want = 100 * nbytes / roofline.HBM_BYTES_PER_S * 2 / 0.5
    assert run.reader("kernels_roofline")(rec()) == pytest.approx(want)
    assert roofline.bound_s(nbytes) == nbytes / roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ["count_s", "write_s", "replays_per_job", "bloom_pass1_s",
                                  "device_idle_pct", "kernels_roofline"])
def test_readers_return_nothing_without_their_source(name):
    empty = rec(jobs=[dict(seconds=1.0, stats={})],
                trace=dict(TRACE, busy_s=0.0, kernel_s=0.0))
    assert run.reader(name)(empty) is None


def test_read_encode_s_times_one_pass(tmp_path):
    p = tmp_path / "r.fa"
    p.write_bytes(b">r0\nACGT\n>r1\nGGCC\n")
    v = run.reader("read_encode_s")(rec(input=dict(path=str(p), codes=10, valid_windows=2)))
    assert v > 0


def test_device_summary_reads_busy_time_ops_and_named_gaps():
    spans = tr.Spans()
    main, other = spans.main, spans.main + 1
    # perf_counter_ns times; the anchor, launched at 500 ns, is the first event
    spans.records += [("job", main, 1_000_000, 9_000_000), ("count_file", main, 2_000_000, 5_000_000),
                      ("reader_wait", main, 2_000_000, 3_000_000), ("write_output", main, 6_000_000, 8_000_000),
                      ("read_encode", other, 0, 10_000_000)]
    a = 7_000.0 - 0.5

    def us(ns):
        return a + ns / 1e3

    ev = [("kernel", "fill", us(500), us(1_500)),
          ("kernel", "k1", us(3_000_000), us(4_000_000)),
          ("kernel", "k1", us(3_500_000), us(4_500_000)),            # overlaps
          ("gpu_memcpy", "Memcpy HtoD", us(6_000_000), us(6_500_000))]
    s = tr.device_summary(ev, spans, 500, 0, 10_000_000)
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.002 + 1e-6)  # 3.0-4.5 ms, 6.0-6.5 ms, the anchor
    assert s["kernel_s"] == pytest.approx(0.002 + 1e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(0.002)]
    gaps = dict(s["idle_gaps"])
    assert gaps["harness"] == pytest.approx(0.002 - 1e-6)   # 0-1 ms and 9-10 ms
    assert gaps["reader_wait"] == pytest.approx(0.001)
    assert gaps["count_file"] == pytest.approx(0.0005)      # 4.5-5 ms
    assert gaps["job"] == pytest.approx(0.003)              # 1-2, 5-6 and 8-9 ms
    assert gaps["write_output"] == pytest.approx(0.0015)
    assert sum(gaps.values()) == pytest.approx(0.010 - s["busy_s"])
    assert tr.device_summary([], spans, 500, 0, 10_000_000) is None


def _two_card_trace():
    """Spans and events of a 10 ms window (perf_counter_ns 0 - 10 ms) in
    which card 0 is busy from 2 to 8 ms and card 1 runs only its anchor,
    before the window."""
    spans = tr.Spans()
    spans.records += [("job", spans.main, 0, 10_000_000),
                      ("count_file", spans.main, 1_000_000, 9_000_000)]
    a = 7_000.0 - 0.5

    def us(ns):
        return a + ns / 1e3

    ev = [("kernel", "fill", us(-5_000), us(-4_000), 0),       # the anchors
          ("kernel", "fill", us(-4_900), us(-3_900), 1),
          ("kernel", "k1", us(2_000_000), us(8_000_000), 0)]
    return ev, spans


def test_device_summary_reads_each_card_on_its_own():
    ev, spans = _two_card_trace()
    s = tr.device_summary(ev, spans, -5_000, 0, 10_000_000)
    assert s["busy_s_per_card"] == [pytest.approx(0.006), 0.0]
    assert s["busy_s"] == pytest.approx(0.003)                # the mean of the cards
    assert run.reader("device_idle_pct")(rec(trace=s)) == pytest.approx(70.0)
    assert s["kernel_s"] == pytest.approx(0.006)              # summed over the cards
    gaps = dict(s["idle_gaps"])                               # the mean of the cards
    assert gaps["count_file"] == pytest.approx((0.002 + 0.008) / 2)
    assert gaps["job"] == pytest.approx((0.002 + 0.002) / 2)
    assert sum(gaps.values()) == pytest.approx(0.010 - s["busy_s"])
    # card 1 idle while card 0 works the whole window: half the cards' time is idle
    full = ev[:2] + [("kernel", "k1", ev[0][2] + 5, ev[0][2] + 10_005, 0)]
    half = tr.device_summary(full, spans, -5_000, 0, 10_000_000)
    assert run.reader("device_idle_pct")(rec(trace=half)) == pytest.approx(50.0)


def test_device_summary_of_one_card_is_the_union_reading():
    ev, spans = _two_card_trace()
    one = [e for e in ev if e[4] == 0]
    s = tr.device_summary(one, spans, -5_000, 0, 10_000_000)
    # an event without a card index is on card 0: the readings are equal
    assert tr.device_summary([e[:4] for e in one], spans, -5_000, 0, 10_000_000) == s
    assert s["busy_s_per_card"] == [s["busy_s"]] and s["busy_s"] == pytest.approx(0.006)
    assert dict(s["idle_gaps"]) == {"count_file": pytest.approx(0.002),
                                    "job": pytest.approx(0.002)}


def test_the_peak_is_taken_over_cards(monkeypatch):
    import torch

    peak = {0: 5, 1: 9, 2: 7, 3: 1}
    calls = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peak[d.index])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d: calls.append(("reset", d.index)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: calls.append(("sync", d.index)))
    devs = run.cards(4, "cuda")
    assert devs == [torch.device("cuda", i) for i in range(4)]
    run.synchronize(devs)
    run.reset_peaks(devs + devs[:1])                 # a card listed twice is reset once
    assert calls == [("sync", i) for i in range(4)] + [("reset", i) for i in range(4)]
    assert run.peaks(devs) == [5, 9, 7, 1] and max(run.peaks(devs)) == 9
    assert run.peaks(run.cards(4, "cpu")) == [0, 0, 0, 0]


def test_spans_wrap_and_unwrap_the_program():
    from kaarme_tpu_torch.models import sort_counter

    before = sort_counter.SortKmerCounter.__dict__["count_file"]
    spans = tr.Spans().install()
    try:
        assert sort_counter.SortKmerCounter.__dict__["count_file"] is not before
        with spans.span("x"):
            pass
        t = threading.Thread(target=lambda: spans.span("y").__enter__())
        t.start()
        t.join(timeout=10)
        assert spans.records[0][0] == "x" and spans.records[0][1] == spans.main
    finally:
        spans.uninstall()
    assert sort_counter.SortKmerCounter.__dict__["count_file"] is before
