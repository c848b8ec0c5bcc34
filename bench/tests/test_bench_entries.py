"""``BENCHMARK.json`` against the rules its entries must keep, and every
entry resolved to its files by name."""
import importlib
import json
import os
import re

import pytest

from bench.lib import harness

BM = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BM["end_to_end"] + BM["per_layer"]


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"][:1] == ["python3"] and len(BM["command"]) <= 32
    for p in BM["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert os.path.isfile(os.path.join(harness.ROOT, BM["command"][1]))


def test_names_units_and_text():
    names = [e["name"] for e in BM["configs"] + BM["workloads"]] + \
        [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in BM["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BM["end_to_end"]}
    texts = [e["why"] for e in BM["configs"] + BM["workloads"]] + \
        [m["layer"] for m in BM["per_layer"]] + \
        [c["source"] for c in BM["configs"]] + BM["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert any(e["name"] == "setup_s" for e in BM["end_to_end"])
    assert len(json.dumps(BM)) <= 64 * 1024


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in BM["workloads"]}
    files = set()
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"] not in files
        files.add(c["file"])
        assert c["file"].startswith(BM["paths"][0] + "/")
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        importlib.import_module("bench.runners." + cfg["runner"])


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_resolves(cell):
    bm, w, cfg, traffic = harness.cell_parts(cell)
    assert w["chips"] in (1, 4) and set(w) == {"name", "config", "traffic",
                                               "chips", "why"}
    assert traffic["limits"] and all(v > 0 for v in traffic["limits"].values())
    reports = [m for m in bm["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    moves = {m["name"] for m in reports}
    layer = [m for m in bm["per_layer"] if harness.applies(m, cell, moves)]
    assert layer
    for m in reports + layer:
        assert callable(harness.load_metric(m["name"]))


def test_cells_are_distinct_pairs_on_one_chip():
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BM["workloads"]) <= max(
        1, len(BM["workloads"]) // 4)
