"""BENCHMARK.json against the rules every later check applies to it:
names, units and files made of the allowed characters, the keys each entry
may have, and each metric's cells reporting what it moves."""

import json
import re

import pytest

from benchmark.harness import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert all(PATH.match(p) for p in bench["paths"])


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(
        bench["workloads"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_setup_another_and_a_layer(bench):
    cells = [w["name"] for w in bench["workloads"]]

    def of(metric):
        return metric.get("workloads", cells)

    for cell in cells:
        e2e = [m["name"] for m in bench["end_to_end"] if cell in of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in of(m) for m in bench["per_layer"])
    e2e = {m["name"]: of(m) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(of(m)) <= set(e2e[m["moves"]]), m["name"]


def test_files_under_paths_are_named_from_name_characters(bench):
    for top in bench["paths"]:
        for f in (ROOT / top).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert PATH.match(str(f.relative_to(ROOT))), f
