"""The port's device-resident batch samplers (`data/device_cache.py`) and
`Trainer.fit_scanned`, mirroring tests/test_train.py's fit_scanned and
device-cache tests, on the CPU."""

import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.data.device_cache import (make_cfm_pair_sampler,
                                                   make_protein_sampler,
                                                   sample_batch, stage)
from tpu_diffusion_torch.data.registry import synthetic_images
from tpu_diffusion_torch.protein.data import get_protein_data
from tpu_diffusion_torch.train import trainer
from tpu_diffusion_torch.train.actions import PeriodicCallback

W_TRUE = torch.tensor([1.5, -2.0])


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))


def _scanned_setup():
    """Toy regression with an on-device batch sampler; the loss also draws
    from the state's generator, as the diffusion losses do."""

    def loss_fn(model, generator, batch):
        noise = 1e-3 * torch.randn(batch.shape[:1], generator=generator)
        return (((batch @ model.w) - batch @ W_TRUE + noise) ** 2).mean()

    model = Linear()
    opt = trainer.make_optimizer(model.parameters(), 1e-1, warmup=0,
                                 grad_clip=1.0, schedule="constant")
    state = trainer.TrainState.create(model, opt,
                                      torch.Generator().manual_seed(0))
    step = trainer.make_train_step(loss_fn, ema_decay=0.9)

    def sample(generator):
        return torch.randn((16, 2), generator=generator)

    return step, state, sample


ROUTES = pytest.mark.parametrize("route", ["graphed", "eager"])


@ROUTES
def test_fit_scanned_chunk_invariant(route):
    """The batch of step s comes from a generator seeded by (base_seed, s):
    the final state is bitwise the same for any chunking, on either route
    (`Trainer(graphed=...)`)."""
    finals = []
    for chunk in (8, 4, 3):       # 3 leaves a tail chunk of 2
        step, state, sample = _scanned_setup()
        tr = trainer.Trainer(step, state, iter(()),
                             graphed=route == "graphed")
        finals.append(tr.fit_scanned(8, sample, chunk=chunk, base_seed=42))
    for other in finals[1:]:
        assert other.step == 8
        torch.testing.assert_close(other.model.w, finals[0].model.w,
                                   rtol=0, atol=0)
        torch.testing.assert_close(other.ema.params["w"],
                                   finals[0].ema.params["w"], rtol=0, atol=0)


@ROUTES
def test_fit_scanned_resume_exact(route):
    """Stopping after 4 steps and going on from the carried state replays
    the stream of an unbroken run."""
    graphed = route == "graphed"
    step, state, sample = _scanned_setup()
    full = trainer.Trainer(step, state, iter(()),
                           graphed=graphed).fit_scanned(
        8, sample, chunk=4, base_seed=7)
    step2, state2, _ = _scanned_setup()
    mid = trainer.Trainer(step2, state2, iter(()),
                          graphed=graphed).fit_scanned(
        4, sample, chunk=4, base_seed=7)
    resumed = trainer.Trainer(step2, mid, iter(()),
                              graphed=graphed).fit_scanned(
        4, sample, chunk=4, base_seed=7)
    torch.testing.assert_close(resumed.model.w, full.model.w, rtol=0,
                               atol=0)


@ROUTES
def test_fit_scanned_equals_fit_on_the_same_batches(route):
    """fit_scanned is fit() fed the sampler's batches of steps 0, 1, ...
    (the eager loop's fit() against either route's fit_scanned)."""
    step, state, sample = _scanned_setup()
    scanned = trainer.Trainer(step, state, iter(()),
                              graphed=route == "graphed").fit_scanned(
        6, sample, chunk=4, base_seed=3)
    batches = (sample(torch.Generator().manual_seed(
        trainer.step_seed(3, s))) for s in range(6))
    step2, state2, _ = _scanned_setup()
    plain = trainer.Trainer(step2, state2, batches, graphed=False).fit(6)
    torch.testing.assert_close(plain.model.w, scanned.model.w, rtol=0,
                               atol=0)


def test_fit_scanned_trains_and_reports_traces():
    step, state, sample = _scanned_setup()
    rows, fired = [], []
    tr = trainer.Trainer(step, state, iter(()),
                         callbacks=[lambda s, **kw: fired.append(s)])
    final = tr.fit_scanned(40, sample, chunk=10,
                           metrics_hook=lambda s, m: rows.append((s, m)))
    assert final.step == 40
    assert [s for s, _ in rows] == [10, 20, 30, 40] == fired
    m = rows[0][1]
    assert m["loss_trace"].shape == (10,) == m["grad_norm_trace"].shape
    assert m["loss"] == m["loss_trace"][-1]
    assert m["loss_mean"] == pytest.approx(float(m["loss_trace"].mean()))
    assert m["steps_per_sec"] > 0
    assert rows[-1][1]["loss"] < rows[0][1]["loss_trace"][0] * 0.5


def test_fit_scanned_refuses_periodic_actions():
    step, state, sample = _scanned_setup()
    cb = PeriodicCallback(callback_fn=lambda **kw: None, every_steps=1)
    tr = trainer.Trainer(step, state, iter(()), callbacks=[cb])
    with pytest.raises(ValueError, match="PeriodicAction"):
        tr.fit_scanned(2, sample)


def test_sample_batch_and_flip():
    ds = synthetic_images(32, 8, 8, 1, 4, seed=3)
    images = stage(ds.images, "cpu")
    assert images.dtype == torch.float32
    b1 = sample_batch(images, torch.Generator().manual_seed(0), 8)
    assert tuple(b1.shape) == (8, 8, 8, 1)
    flat = images.reshape(32, -1)
    for row in b1.reshape(8, -1):   # every sampled row is a dataset row
        assert ((flat - row).abs().max(1).values < 1e-6).any()
    b1b = sample_batch(images, torch.Generator().manual_seed(0), 8)
    torch.testing.assert_close(b1, b1b, rtol=0, atol=0)
    bf = sample_batch(images, torch.Generator().manual_seed(0), 64,
                      flip=True)
    both = torch.cat([flat, images.flip(2).reshape(32, -1)])
    flipped = 0
    for row in bf.reshape(64, -1):   # every row is a row or its mirror
        d = (both - row).abs().max(1).values < 1e-6
        assert d.any()
        flipped += int(not d[:32].any())
    assert 0 < flipped < 64


def test_cfm_pair_sampler_couples():
    """The sinkhorn coupling beats the independent one on mean pair
    distance."""
    ds = synthetic_images(64, 8, 8, 1, 4, seed=0)
    images = stage(ds.images, "cpu")
    paired = make_cfm_pair_sampler(images, 32, ot="sinkhorn")
    indep = make_cfm_pair_sampler(images, 32, ot=None)

    def dist(xy):
        return float(((xy[0] - xy[1]) ** 2).sum((1, 2, 3)).mean())

    gen = torch.Generator().manual_seed(5)
    assert dist(paired(gen)) < dist(indep(torch.Generator().manual_seed(5)))
    with pytest.raises(ValueError, match="exact"):
        make_cfm_pair_sampler(images, 32, ot="exact")


def test_protein_sampler_masks_come_from_lengths():
    ds = get_protein_data("does/not/exist", max_len=24, n_synthetic=16)
    sample = make_protein_sampler(ds.positions, ds.lengths, 8, device="cpu")
    b = sample(torch.Generator().manual_seed(0))
    assert tuple(b["pos"].shape) == (8, 24, 3)
    assert tuple(b["mask"].shape) == (8, 24)
    assert b["mask"].dtype == torch.bool
    m = b["mask"].numpy()
    runs = m.sum(1)
    np.testing.assert_array_equal(m, np.arange(24)[None] < runs[:, None])
    assert set(runs.tolist()) <= set(ds.lengths.tolist())
    flat = ds.positions.reshape(16, -1)
    for row, n in zip(b["pos"].numpy().reshape(8, -1), runs):
        hit = np.abs(flat - row).max(1) < 1e-6
        assert hit.any() and set(ds.lengths[hit].tolist()) == {n}


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        stage(np.zeros((2, 2, 2, 1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_protein_sampler(np.zeros((2, 4, 3)), np.array([2, 4]), 2)
