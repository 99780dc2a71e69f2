"""The harness end to end on the CPU at a small size: sound runs come out
correct, runs with the timed path broken underneath and the controls come
out not correct, and without a card it refuses to run.  The judge reads
alike in one key-hash part and in four (four CPU devices), and a cell
sharded over four CPU shards is judged in four parts."""

import json
import os
import subprocess
import sys

import pytest
import torch

from kbench import control, judge, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["ecoli-k51.err1pct", "ecoli-k51-bf.err1pct"]


def small(name, genome=20_000):
    """The cell at a genome the CPU test run holds (``-u`` scaled alike)."""
    cell = run.load_cell(name)
    cell["params"]["genome_bases"] = genome
    flags = cell["config"]["flags"]
    if "-u" in flags:
        flags[flags.index("-u") + 1] = str(genome * 3)
    return cell


def four_shards(genome=20_000):
    """A four-card cell built here, not in BENCHMARK.json: ``ecoli-k51.err1pct``
    sharded over four CPU shards (``--devices 4``), judged in four parts."""
    cell = small("ecoli-k51.err1pct", genome)
    cell["chips"] = 4
    cell["config"]["flags"] = ["--devices", "4", *cell["config"]["flags"]]
    return cell


def _judged_in_one_part_too(monkeypatch) -> list:
    """Make ``run.compare`` judge the same outputs in one part as well;
    returns the list of one-part checks, one per judged job."""
    seen, compare = [], run.compare

    def both(cfg, inp, reference, store, text, jobs_failed):
        whole = [tuple(torch.cat(c) for c in zip(*store))]
        seen.append(compare(cfg, inp, run.reference_parts(cfg, inp, [torch.device("cpu")]),
                            whole, text, jobs_failed))
        return compare(cfg, inp, reference, store, text, jobs_failed)

    monkeypatch.setattr(run, "compare", both)
    return seen


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("parts", [1, 4])
def test_a_sound_run_is_correct(monkeypatch, name, trace, parts):
    one_part = _judged_in_one_part_too(monkeypatch)
    res = run.run_cell(small(name), 2**31 + 17, 0.3, bool(trace), device="cpu", parts=parts)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "checks" and res["checks"] == one_part[-1]
    assert res["device"]["memory_peak_bytes_per_card"] == [0]
    exact = {n: d for n, d in res["checks"].items() if n != "bloom_singletons_kept"}
    assert all(d["value"] == 0 == d["limit"] for d in exact.values())
    assert ("bloom_singletons_kept" in res["checks"]) == ("bf" in name)
    want = {m["name"] for m in run.load_cell(name)["end_to_end" if not trace else "per_layer"]}
    if trace:
        # no device on the CPU: the trace's readers find nothing to read
        want -= {"device_idle_pct", "kernels_roofline"}
    assert set(res["metrics"]) == want


def _unchanged_step(self, packed_d, sep_d, n, dense):
    """A superstep that leaves the store as it was."""


def _half_batch(pack):
    def wrapped(stream, n):
        stream = stream.copy()
        stream[n // 2:] = 4              # the second half of the windows left out
        return pack(stream, n)
    return wrapped


def _altered_count(dump_columns):
    def wrapped(self):
        parts = dump_columns(self)
        keys, cnt = parts[0]
        cnt = cnt.clone()
        cnt[torch.nonzero(cnt > 1)[0]] += 1
        return [(keys, cnt)] + parts[1:]
    return wrapped


def _altered_text(fmt):
    def wrapped(*a, **kw):
        text, lines = fmt(*a, **kw)
        text = text.clone()
        text[text.numel() // 2] = ord("A") if text[text.numel() // 2] != ord("A") else ord("C")
        return text, lines
    return wrapped


def _passes_every_key(bf2, keys, hfn, kernels="cuda"):
    """A pass-2 gate that keeps nothing out."""
    return keys


def _drops_a_bucket(exchange):
    def wrapped(shard_cols, owners, devices):
        """Source shard 0's records for owner shard 1 never arrive."""
        keep = owners[0] != 1
        return exchange([tuple(c[keep] for c in shard_cols[0]), *shard_cols[1:]],
                        [owners[0][keep], *owners[1:]], devices)
    return wrapped


def _break(monkeypatch, fault):
    from kaarme_tpu_torch.models import skm_counter, sort_counter
    from kaarme_tpu_torch.ops import skm, sortcount, writer
    from kaarme_tpu_torch.parallel import sharded_sort

    if fault == "step_returns_state_unchanged":
        monkeypatch.setattr(skm_counter.SkmCounter, "_dispatch", _unchanged_step)
    elif fault == "half_of_each_superstep_left_out":
        monkeypatch.setattr(sort_counter, "pack_chunk", _half_batch(sort_counter.pack_chunk))
    elif fault == "count_altered_in_the_store":
        monkeypatch.setattr(skm_counter.SkmCounter, "dump_columns",
                            _altered_count(skm_counter.SkmCounter.dump_columns))
    elif fault == "byte_altered_in_the_count_file":
        monkeypatch.setattr(writer, "format_lines_plain", _altered_text(writer.format_lines_plain))
    elif fault == "gate_passes_every_key":
        monkeypatch.setattr(skm, "bloom_gate", _passes_every_key)
        monkeypatch.setattr(sortcount, "bloom_gate", _passes_every_key)
    elif fault == "exchange_drops_a_bucket":
        monkeypatch.setattr(sharded_sort, "exchange", _drops_a_bucket(sharded_sort.exchange))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["step_returns_state_unchanged",
                                   "half_of_each_superstep_left_out",
                                   "count_altered_in_the_store",
                                   "byte_altered_in_the_count_file"])
@pytest.mark.parametrize("parts", [1, 4])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault, parts):
    # one card: these cells have no exchange between chips to leave out;
    # the four-shard cell's is left out below
    one_part = _judged_in_one_part_too(monkeypatch)
    _break(monkeypatch, fault)
    res = run.run_cell(small(name), 2**31 + 19, 0.2, False, device="cpu", parts=parts)
    assert not res["correct"] and res["failed"] >= 1
    assert any(d["value"] > d["limit"] for d in res["checks"].values())
    assert res["checks"] == one_part[-1]


def test_a_four_shard_run_is_correct(monkeypatch):
    one_part = _judged_in_one_part_too(monkeypatch)
    res = run.run_cell(four_shards(), 2**31 + 31, 0.3, False, device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert res["device"]["count"] == 4 and len(res["device"]["memory_peak_bytes_per_card"]) == 4
    assert all(d["value"] == 0 == d["limit"] for d in res["checks"].values())
    assert res["checks"] == one_part[-1]


def test_an_exchange_that_drops_a_bucket_is_not_correct(monkeypatch):
    _break(monkeypatch, "exchange_drops_a_bucket")
    res = run.run_cell(four_shards(), 2**31 + 37, 0.2, False, device="cpu")
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["store_rows_off"]["value"] > 0
    assert res["checks"]["file_lines_off"]["value"] > 0


def test_a_filter_that_keeps_nothing_out_is_not_correct(monkeypatch):
    _break(monkeypatch, "gate_passes_every_key")
    res = run.run_cell(small("ecoli-k51-bf.err1pct"), 2**31 + 21, 0.2, False, device="cpu")
    assert not res["correct"] and res["failed"] >= 1
    assert [n for n, d in res["checks"].items() if d["value"] > d["limit"]] == [
        "bloom_singletons_kept"]


@pytest.mark.parametrize("name", ["ecoli-k51.err1pct", "ecoli-k51-bf.err1pct"])
def test_the_controls_are_not_correct(monkeypatch, name):
    monkeypatch.setattr(control, "SEAM_BYTES", 1 << 18)     # seams in a small input
    sides = dict(control.readings(small(name, genome=150_000), 2**31 + 23, True, device="cpu"))
    assert judge.ok(sides.pop("program"))
    assert set(sides) == ({"chunk_seam", "one_pass_bloom", "no_gate"} if "bf" in name else {"chunk_seam"})
    assert all(not judge.ok(checks) for checks in sides.values())


def test_without_a_card_it_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "kbench/run.py", "--workload", "ecoli-k51.err1pct",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct(cuda_card):
    res = run.run_cell(small("ecoli-k51-bf.err1pct", genome=200_000), 2**31 + 29, 1.0, True)
    assert res["correct"] and res["device"]["busy_s"] > 0
    json.dumps(res)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
