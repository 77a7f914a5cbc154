"""The port's checkpoint manager and warm-start helpers (torch.save files),
with the semantics of `tpu_diffusion/train/checkpoint.py`: retention of the
newest three, restart from the latest, the initial assets from an empty
directory, and the shape-matched partial load."""

import os

import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.train.checkpoint import (CheckpointManager,
                                                  load_matching_params,
                                                  load_pretrained)


def _assets(step):
    g = torch.Generator().manual_seed(step)
    return {"params": {"conv.weight": torch.randn((4, 3, 3, 3), generator=g),
                       "conv.bias": torch.randn(4, generator=g)},
            "ema": {"conv.weight": torch.randn((4, 3, 3, 3), generator=g),
                    "conv.bias": torch.randn(4, generator=g)},
            "step": step}


def _same(a, b):
    assert a["step"] == b["step"]
    for tree in ("params", "ema"):
        assert sorted(a[tree]) == sorted(b[tree])
        for k in a[tree]:
            assert torch.equal(a[tree][k], b[tree][k])


def test_load_on_an_empty_directory_returns_the_initial_assets(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    initial = _assets(0)
    assets, step = mgr.load(initial)
    assert assets is initial and step == 0
    assert mgr.latest_step() is None
    assert load_pretrained(str(tmp_path / "ckpt")) is None
    assert load_pretrained(str(tmp_path / "missing")) is None


def test_retention_of_three_and_restart_from_the_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), maximum=3)
    for step in (10, 20, 30, 40, 50):
        assert mgr.save(step, _assets(step))
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["ckpt_00000030.pt", "ckpt_00000040.pt",
                    "ckpt_00000050.pt"]
    assert mgr.latest_step() == 50
    assets, step = CheckpointManager(str(tmp_path)).load(_assets(0))
    assert step == 50
    _same(assets, _assets(50))
    _same(load_pretrained(str(tmp_path)), _assets(50))
    # parameters that require grad are saved as plain tensors
    live = {"params": {"w": torch.nn.Parameter(torch.ones(2))}, "step": 60}
    mgr.save(60, live)
    loaded, step = mgr.load(live)
    assert step == 60 and not loaded["params"]["w"].requires_grad
    assert torch.equal(loaded["params"]["w"], torch.ones(2))
    assert len(os.listdir(tmp_path)) == 3


def test_load_matching_params_counts_copied_and_skipped():
    params = {"a.weight": torch.zeros(4, 3), "a.bias": torch.zeros(4),
              "b.weight": torch.zeros(2, 2)}
    loaded = {"a": {"weight": torch.ones(4, 3), "bias": torch.ones(5)},
              "c.weight": torch.ones(2, 2)}
    merged, copied, skipped = load_matching_params(params, loaded)
    assert (copied, skipped) == (1, 2)  # one shape mismatch, one unknown
    assert torch.equal(merged["a.weight"], torch.ones(4, 3))
    assert torch.equal(merged["a.bias"], torch.zeros(4))
    assert torch.equal(merged["b.weight"], torch.zeros(2, 2))
    assert sorted(merged) == sorted(params)


def test_save_is_atomic_and_ignores_foreign_files(tmp_path):
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "ckpt_00000005.pt.tmp").write_text("partial")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    mgr.save(7, _assets(7))
    assert mgr.latest_step() == 7
    with pytest.raises(Exception):
        torch.load(tmp_path / "ckpt_00000005.pt.tmp", weights_only=True)
