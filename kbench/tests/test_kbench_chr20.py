"""The four-card cell ``chr20-k51-x4.err1pct`` (``run.load_cell``) at a
genome the CPU test run holds, on four CPU shards: judged correct in
four key-hash parts and in one alike, and its traced run reads the
sharded counters' exchange, key-range dump and moved rows."""

import os

import pytest
import torch

from kbench import run

KB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "chr20-k51-x4.err1pct"
NEW = {"exchange_s": "s", "range_dump_s": "s", "dump_rows_moved_per_job": "rows/job"}


def cell(genome: int = None) -> dict:
    c = run.load_cell(CELL)
    if genome is not None:
        c["params"]["genome_bases"] = genome
    return c


def test_the_deployment_is_the_sharded_route_at_chr20_scale():
    c = cell()
    assert c["chips"] == 4 and c["config"]["name"] == "chr20-k51-x4"
    assert c["config"]["flags"][:2] == ["--devices", "4"] and "-b" not in c["config"]["flags"]
    assert c["config"]["k"] == 51 and c["config"]["reference"] == "kmer_count"
    p = c["params"]
    assert p["genome_bases"] * p["coverage"] // p["read_len"] == 12_888_833
    assert p["substitution_rate"] == 0.01
    assert {m["name"]: m["unit"] for m in c["per_layer"]} == NEW
    assert all(os.path.isfile(os.path.join(KB, "metrics", n + ".py")) for n in NEW)


@pytest.mark.parametrize("parts", [1, 4])
def test_a_small_run_is_correct_in_four_parts_and_in_one(monkeypatch, parts):
    seen, compare = [], run.compare

    def both(cfg, inp, reference, store, text, jobs_failed):
        whole = [tuple(torch.cat(c) for c in zip(*store))]
        seen.append(compare(cfg, inp, run.reference_parts(cfg, inp, [torch.device("cpu")]),
                            whole, text, jobs_failed))
        return compare(cfg, inp, reference, store, text, jobs_failed)

    monkeypatch.setattr(run, "compare", both)
    res = run.run_cell(cell(20_000), 2**31 + 41, 0.3, False, device="cpu", parts=parts)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert res["device"]["count"] == 4
    assert all(d["value"] == 0 == d["limit"] for d in res["checks"].values())
    assert res["checks"] == seen[-1]


def test_a_traced_run_reads_the_new_metrics():
    res = run.run_cell(cell(20_000), 2**31 + 43, 0.3, True, device="cpu")
    assert res["correct"]
    assert {n: m["unit"] for n, m in res["metrics"].items()} == NEW
    got = {n: m["value"] for n, m in res["metrics"].items()}
    assert got["exchange_s"] > 0 and got["range_dump_s"] > 0
    assert got["dump_rows_moved_per_job"] > 0


@pytest.mark.parametrize("name", list(NEW))
def test_the_new_readers_read_nothing_from_a_program_without_them(name):
    # a program before the key-range dump, or a one-card job: no such key
    rec = dict(k=51, jobs=[dict(seconds=1.0, stats=dict(build_seconds=0.5, write_seconds=0.2))],
               trace=None, input=dict(path="", codes=10, valid_windows=10),
               judged=dict(store_rows=1, key_words=4, text_bytes=1))
    assert run.reader(name)(rec) is None
