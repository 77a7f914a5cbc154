"""The cells of FLUX.1 Fill [dev] and of the rematerialised 64px training
step: FLUX's frozen counts (its FLOPs and parameters on the reference),
and the comparison that decides `correct` shown to fail on the CPU at the
rehearsal sizes under planted faults (an Euler step that leaves its state
unchanged, the requests' condition left stale, the guidance embedding
dropped, the linear grid in place of the shifted one) and under the
control, the fp8 reference, in the system's place; the remat cell's
recomputation engaged, and the training faults caught there too."""

import json

import pytest
import torch

from benchmark.counts.flux_flops import forward_flops
from benchmark.drivers import flux_fill_chain
from benchmark.harness import ROOT
from benchmark.reference.flux import Flux, euler_chain, fill_condition, pack
from benchmark.reference.lowp import fp8
from benchmark.tests import test_harness_faults as faults

FLUX = "flux1-fill-euler50-1024"
REMAT = "flowers64-train-remat"


def config():
    with open(ROOT / "benchmark" / "configs" / "flux1-fill-dev.json") as f:
        return json.load(f)


def test_flux_counts():
    cfg = config()
    flops = forward_flops(cfg["model"], 512, 64, 64)
    assert flops == 74_392_706_482_176
    with torch.device("meta"):
        model = Flux(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert cfg["parameters"] == 11_902_391_360


def step_unchanged(mp):
    from tpu_diffusion_torch.sampling import ode
    mp.setattr(ode, "_euler_step", lambda v, t, tn, x: x + 0 * v(t, x))


def condition_stale(mp):
    """The requests' condition, context and pooled vector reach the
    chain's buffers only at set-up."""
    fill = flux_fill_chain.Driver._fill

    def stale(self, req):
        if not hasattr(self, "_filled"):
            self._filled = True
            fill(self, req)

    mp.setattr(flux_fill_chain.Driver, "_fill", stale)


def guidance_dropped(mp):
    from tpu_diffusion_torch.models.flux import FluxTransformer
    velocity = FluxTransformer.velocity
    mp.setattr(FluxTransformer, "velocity",
               lambda self, g, *a, **kw: velocity(self, 1.0, *a, **kw))


def linear_grid(mp):
    from tpu_diffusion_torch.sampling import ode
    mp.setattr(ode, "shifted_sigmas",
               lambda n, *a, **kw: torch.linspace(1.0, 0.0, n + 1,
                                            dtype=torch.float64))


def flux_control(mp):
    setup = flux_fill_chain.Driver.setup

    def control(self):
        setup(self)
        low = self.reference(fp8)

        def run(req):
            x_T, mask, latent, ctx, pooled = req
            return euler_chain(low, pack(x_T), fill_condition(
                mask, latent, self.scale), ctx, pooled, self.guidance,
                self._grid(), self.hw)[0]

        self._run = run

    mp.setattr(flux_fill_chain.Driver, "setup", control)


@pytest.mark.parametrize("fault", [step_unchanged, condition_stale,
                                   guidance_dropped, linear_grid,
                                   flux_control])
def test_flux_fault_is_caught(rehearse, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(FLUX)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_flux_driver_routes_and_counters():
    """The rehearsal's blocks (one period of the 1:2 pattern), their
    decisions, one replay a step, and the chain's FLOPs."""
    from benchmark import harness
    cell = harness.load_cell(FLUX)
    driver = flux_fill_chain.Driver(cell, 2**31 + 7, torch.device("cpu"),
                                    rehearse=True)
    driver.setup()
    driver.unit()
    routes = driver.routes()
    assert routes["blocks"] == {"double": 1, "single": 2}
    assert routes["attention"] == ["double plain [2,72,16] text 8 image 64",
                                   "single plain [2,72,16] text 8 image 64"]
    assert routes["replays_per_chain"] == {"1": 2 * 3}
    counters = driver.counters()
    assert counters["flops_per_item"] == 3 * forward_flops(
        driver.sizes, 8, 8, 8)
    assert counters["kernel_calls"] == {"flash_fwd": []}  # CPU: plain


def test_remat_recomputes(rehearse, monkeypatch):
    """The remat cell's step runs every ResBlock through the checkpoint,
    and stays correct."""
    from tpu_diffusion_torch.models import unet
    calls = []
    checkpointed = unet.checkpointed

    def counted(*args, **kw):
        calls.append(1)
        return checkpointed(*args, **kw)

    monkeypatch.setattr(unet, "checkpointed", counted)
    rc, line, err = rehearse(REMAT)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert calls


@pytest.mark.parametrize("fault", [faults.state_unchanged,
                                   faults.half_batch_loss,
                                   faults.update_altered,
                                   faults.training_control])
def test_remat_fault_is_caught(rehearse, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = rehearse(REMAT)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
