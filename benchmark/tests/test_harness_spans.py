"""The readers of the program's span summary (`benchmark/program_spans.py`)
on a fake summary: each reads its number, the summary is asked for once
per run and printed as one `spans` line on standard error; where the
program holds nothing, or has no recorder at all, each reads None."""

import json
import sys

import pytest

from benchmark import harness
from tpu_diffusion_torch.utils import spans

READERS = ["host_turn_ms.sample", "encode_ms.sample", "decode_ms.sample",
           "forward_ms.train", "backward_ms.train", "update_ms.train"]

FAKE = {
    "window_s": 51.0, "replays": 5000, "replay_s": 50.0, "gap_s": 1.0,
    "turns": {"chain": {"count": 150, "median_ms": 1.6, "max_ms": 5.0},
              "step": {"count": 4, "median_ms": 0.02, "max_ms": 0.5}},
    "markers": {
        "chain/1": {"count": 150, "names": ["encode", "end"],
                    "median_ms": [1.0, 2.9], "replay_ms_median": 3.9},
        "chain/3": {"count": 150, "names": ["encode", "end"],
                    "median_ms": [1.05, 8.61], "replay_ms_median": 9.66},
        "step/1": {"count": 120, "names": ["forward", "backward", "end"],
                   "median_ms": [22.0, 41.0, 2.5],
                   "replay_ms_median": 65.5}},
    "unread": 3}

WANT = {"host_turn_ms.sample": 1.6, "encode_ms.sample": 1.05,
        "decode_ms.sample": 8.61 / 3, "forward_ms.train": 22.0,
        "backward_ms.train": 41.0, "update_ms.train": 2.5}


def _run():
    return harness.Run(setup_s=1.0, t_start=10.0, units=[(10.0, 12.0, 64)])


def test_readers_on_a_fake_summary(monkeypatch, capsys):
    asked = []

    def summary(t0, t1):
        asked.append((t0, t1))
        return FAKE

    monkeypatch.setattr(spans, "summary", summary)
    run = _run()
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got == pytest.approx(WANT)
    assert asked == [(10.0, 12.0)]
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("spans ")]
    assert len(lines) == 1 and json.loads(lines[0][6:]) == FAKE


@pytest.mark.parametrize("held", [None, {"window_s": 2.0, "spans": {},
                                         "markers": {}, "unread": 0}])
def test_readers_read_none_where_nothing_is_held(monkeypatch, held):
    monkeypatch.setattr(spans, "summary", lambda t0, t1: held)
    run = _run()
    assert all(harness.reader(name)(run) is None for name in READERS)


def test_readers_read_none_without_the_recorder(monkeypatch, capsys):
    """A program that lacks `utils/spans.py` (an older checkout): the
    import fails, nothing is printed."""
    import tpu_diffusion_torch.utils as utils
    monkeypatch.setattr(spans, "summary", lambda t0, t1: FAKE)
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "tpu_diffusion_torch.utils.spans", None)
    run = _run()
    assert all(harness.reader(name)(run) is None for name in READERS)
    assert "spans " not in capsys.readouterr().err
