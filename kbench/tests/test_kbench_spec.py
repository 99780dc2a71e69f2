"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits, and every file the harness finds by a name."""

import json
import os
import re

import pytest

KB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(KB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
    for c in bench["configs"]:
        assert all(NAME.match(r) for r in c["reduced"]) and len(c["reduced"]) <= 16
        assert line(c["source"]) and line(c["why"])
    for m in bench["per_layer"]:
        assert line(m["layer"])


def test_entries_have_exactly_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_cells_metrics_and_files(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(cells) <= 24 and len(configs) <= 24
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(KB, "reference", cfg["reference"] + ".py"))
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert w["config"] in configs
        assert os.path.isfile(os.path.join(KB, "traffic", w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
        assert os.path.isfile(os.path.join(KB, "metrics", m["name"] + ".py"))
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for name in cells:
        mine = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(name in m.get("workloads", cells) for m in bench["per_layer"])


def test_layers_are_one_name_each(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"io", "count", "bloom", "writer", "kernels", "device"}


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                assert all(NAME.match(part) for part in rel.split("/")), rel
