"""Each cell rehearsed on the CPU at the tiny sizes of its files' rehearsal
blocks: the last line of standard output is the result, with the keys the
contract names; a run without a card, or in a directory that holds only
the benchmark, prints no result."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(rehearse, cell, trace):
    rc, line, err = rehearse(cell, trace=trace)
    assert rc == 0, err
    keys = list(line)
    assert [k for k in keys if k not in ("breakdown", "checks")] == KEYS
    assert keys[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    # every number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith('{"correct"')
                   for line in proc.stdout.splitlines())
