"""BENCHMARK.json is well formed and every piece it names is there."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 << 10


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_files_exist(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert w["chips"] == 1
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_metrics_cells_and_moves(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) - 1 <= 4
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in cells:   # each cell reports setup_s, another e2e, a per-layer
        assert sum(w in m.get("workloads", cells) for m in e2e.values()) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
