"""The comparison that decides `correct`, shown to fail: each cell's run
on the CPU at its rehearsal sizes, with the timed path broken underneath
(a step that leaves its state unchanged, half of the batch left out, an
answer altered where it is produced, the per-step host fill of the
optimizer's scalars gone stale after the first replay, an EMA left
unblended or blended with the wrong weight) or with the control, the fp8
reference, put in the system's place, reads `correct` false."""

import pytest
import torch

from benchmark.drivers import ddim_chain, train_step
from benchmark.reference.diffusion import ddim_chain as reference_chain
from benchmark.reference.lowp import fp8

SAMPLING = ["cifar10-ddim100-k3", "cifar10-ddim100-k1"]
TRAINING = ["flowers64-train-bf16"]


def step_unchanged(mp):
    from tpu_diffusion_torch.sampling import ancestral
    mp.setattr(ancestral, "_ddim_step", lambda xi, eps, c, noise: xi)


def half_of_the_batch(mp):
    from tpu_diffusion_torch.sampling import ancestral
    step = ancestral._ddim_step

    def half(xi, eps, c, noise):
        h = eps.shape[0] // 2
        return step(xi, torch.cat([eps[:h], eps[:h]]), c, noise)

    mp.setattr(ancestral, "_ddim_step", half)


def answer_altered(mp):
    from tpu_diffusion_torch.sampling import ancestral
    chain = ancestral._graphed_ddim

    def altered(*args, **kw):
        out = chain(*args, **kw)
        out[0] = -out[0]
        return out

    mp.setattr(ancestral, "_graphed_ddim", altered)


def sampling_control(mp):
    setup = ddim_chain.Driver.setup

    def control(self):
        setup(self)
        low = self.reference(fp8)
        self.sample = lambda x_T: reference_chain(
            low, x_T, self.num_steps, self.steps, self.reuse)

    mp.setattr(ddim_chain.Driver, "setup", control)


def state_unchanged(mp):
    from tpu_diffusion_torch.train.trainer import Optimizer
    update = Optimizer.update

    def frozen(self, metrics=()):
        saved = [p.detach().clone() for p in self.params]
        gnorm = update(self, metrics)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return gnorm

    mp.setattr(Optimizer, "update", frozen)


def half_batch_loss(mp):
    from tpu_diffusion_torch.cli import main as cli
    make_loss = cli.make_loss

    def half(parts):
        loss = make_loss(parts)
        return lambda model, gen, batch: loss(model, gen,
                                              batch[:batch.shape[0] // 2])

    mp.setattr(cli, "make_loss", half)


def update_altered(mp):
    """One parameter's update doubled where the optimizer makes it."""
    from tpu_diffusion_torch.train.trainer import Optimizer
    update = Optimizer.update

    def doubled(self, metrics=()):
        p = self.params[-1]
        before = p.detach().clone()
        gnorm = update(self, metrics)
        with torch.no_grad():
            p.add_(p - before)
        return gnorm

    mp.setattr(Optimizer, "update", doubled)


def host_fill_stale(mp):
    """The optimizer's per-step scalars (learning rate, bias corrections)
    written for the first three steps only, as a replay that reads a
    buffer the host no longer fills would see them."""
    from tpu_diffusion_torch.train.trainer import Optimizer
    fill = Optimizer.fill

    def stale(self):
        if self.count < 3:
            fill(self)
        else:
            self.count += 1

    mp.setattr(Optimizer, "fill", stale)


def ema_not_blended(mp):
    """The EMA body leaves the EMA as it was."""
    from tpu_diffusion_torch.train import trainer
    mp.setattr(trainer, "ema_blend", lambda state, params: None)


def ema_without_ramp(mp):
    """The EMA blended with the full decay from its first blend on, its
    warm-up ramp dropped."""
    from tpu_diffusion_torch.train import trainer
    fill = trainer.ema_fill
    mp.setattr(trainer, "ema_fill",
               lambda state, **kw: fill(state, **{**kw, "warmup": False}))


def training_control(mp):
    setup = train_step.Driver.setup

    def control(self):
        setup(self)
        self.readings_of_system = self.reference_readings(fp8)

    mp.setattr(train_step.Driver, "setup", control)


@pytest.mark.parametrize("fault", [step_unchanged, half_of_the_batch,
                                   answer_altered, sampling_control])
@pytest.mark.parametrize("cell", SAMPLING)
def test_sampling_fault_is_caught(rehearse, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_loss,
                                   update_altered, host_fill_stale,
                                   ema_not_blended,
                                   ema_without_ramp, training_control])
@pytest.mark.parametrize("cell", TRAINING)
def test_training_fault_is_caught(rehearse, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
