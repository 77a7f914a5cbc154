"""The cells of the latent-diffusion configuration and of the amortized
64px sampler: their frozen counts (the SD2 UNet's FLOPs and parameters on
the reference, the cross-attention bound), and the comparison that decides
`correct` shown to fail on the CPU at the rehearsal sizes under planted
faults (guidance dropped, the requests' condition left stale, a step that
leaves its state unchanged, either half of the batch left out) and under the
control, the fp8 reference, in the system's place."""

import json

import pytest
import torch

from benchmark.counts.ldm_flops import forward_flops
from benchmark.counts.xattn_bounds import xattn
from benchmark.drivers import amortized_chain, ldm_chain
from benchmark.harness import ROOT
from benchmark.reference.ancestral import amortized_chain as reference_chain
from benchmark.reference.ldm_unet import LDMUNet, ddim_cfg_chain
from benchmark.reference.lowp import fp8

SD2 = "sd2-inpaint-ddim50-cfg"
AMORTIZED = "flowers64-inpaint-amortized"


def config():
    with open(ROOT / "benchmark" / "configs" / "sd2-inpaint-unet.json") as f:
        return json.load(f)


def test_sd2_counts():
    cfg = config()
    assert forward_flops(cfg["model"]) == 804_375_429_120
    with torch.device("meta"):
        model = LDMUNet(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert cfg["parameters"] == 865_925_124


def test_cross_attention_bound():
    # bytes: q and o at Tq = 4096, 40 slices, over 3.35 TB/s
    assert xattn(40, 4096, 77, 64) * 1e6 == pytest.approx(12.76, abs=0.01)


def guidance_dropped(mp):
    from tpu_diffusion_torch.sampling import ancestral
    cfg = ancestral.classifier_free_eps_fn
    mp.setattr(ancestral, "classifier_free_eps_fn",
               lambda eps_fn, scale: cfg(eps_fn, 1.0))


def condition_stale(mp):
    """The requests' contexts and condition reach the chain's buffers only
    at set-up."""
    fill = ldm_chain.Driver._fill

    def stale(self, cond, ctx):
        if not hasattr(self, "_filled"):
            self._filled = True
            fill(self, cond, ctx)

    mp.setattr(ldm_chain.Driver, "_fill", stale)


def step_unchanged(mp):
    from tpu_diffusion_torch.sampling import ancestral
    mp.setattr(ancestral, "_ddim_step",
               lambda xi, eps, c, noise, clip=True: xi)


def sd2_control(mp):
    setup = ldm_chain.Driver.setup

    def control(self):
        setup(self)
        low = self.reference(fp8)
        abar = self._abar()

        def sample(x_T):
            cond = self.cond2[:self.batch]
            ctx = self.ctx2[:self.batch]
            return ddim_cfg_chain(low, x_T, cond, ctx, self.ctx_u, abar,
                                  self.steps, self.scale)[0]

        self.sample = sample

    mp.setattr(ldm_chain.Driver, "setup", control)


def posterior_unchanged(mp):
    from tpu_diffusion_torch.sampling import ancestral
    mp.setattr(ancestral, "_posterior_update",
               lambda ddpm, x0, xi, ib, noise: xi)


def half_of_the_batch(mp):
    from tpu_diffusion_torch.sampling import ancestral
    update = ancestral._posterior_update

    def half(ddpm, x0, xi, ib, noise):
        h = x0.shape[0] // 2
        return update(ddpm, torch.cat([x0[h:], x0[h:]]), xi, ib, noise)

    mp.setattr(ancestral, "_posterior_update", half)


def second_half_unchanged(mp):
    """The posterior step updates the batch's first half only."""
    from tpu_diffusion_torch.sampling import ancestral
    update = ancestral._posterior_update

    def half(ddpm, x0, xi, ib, noise):
        h = x0.shape[0] // 2
        return torch.cat([update(ddpm, x0, xi, ib, noise)[:h], xi[h:]])

    mp.setattr(ancestral, "_posterior_update", half)


def second_half_copied(mp):
    """The batch's second half takes the first half's x0 prediction."""
    from tpu_diffusion_torch.sampling import ancestral
    update = ancestral._posterior_update

    def half(ddpm, x0, xi, ib, noise):
        h = x0.shape[0] // 2
        return update(ddpm, torch.cat([x0[:h], x0[:h]]), xi, ib, noise)

    mp.setattr(ancestral, "_posterior_update", half)


def amortized_control(mp):
    setup = amortized_chain.Driver.setup

    def control(self):
        setup(self)
        low = self.reference(fp8)
        self.cond_sample = lambda model, x_T, cond, gen: reference_chain(
            low, x_T, cond, gen, self.num_steps, self.reuse)

    mp.setattr(amortized_chain.Driver, "setup", control)


@pytest.mark.parametrize("fault", [guidance_dropped, condition_stale,
                                   step_unchanged, sd2_control])
def test_sd2_fault_is_caught(rehearse, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(SD2)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", [posterior_unchanged, half_of_the_batch,
                                   second_half_unchanged, second_half_copied,
                                   amortized_control])
def test_amortized_fault_is_caught(rehearse, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(AMORTIZED)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
