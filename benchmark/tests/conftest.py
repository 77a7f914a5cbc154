"""Shared fixtures of the benchmark's CPU tests: one torch thread (several
test workers share the cores), and a rehearsal run of a cell in this
process, returning its exit code, its result line and its standard
error."""

import json

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rehearse(capsys):
    from benchmark import run

    def go(cell, seed=2**31 + 11, trace=0):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.5", "--trace", str(trace), "--rehearse"])
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        line = json.loads(lines[-1]) if rc == 0 else None
        return rc, line, err

    return go
