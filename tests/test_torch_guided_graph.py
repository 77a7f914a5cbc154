"""The graphed reconstruction-guidance chain on the CPU.

On a CPU tensor the graphed chain runs its bodies in a Python loop: a plain
body for the steps at or above `start_step` and a guided body below it,
whose step takes the guidance gradient through the model, each with its
noise-free step-0 twin. It is held bitwise against the eager chain, and
against the JAX package's two-scan sampler with the JAX noise replayed
(tiny UNet twins, dense attention, fp32); `cli.make_samplers` keeps it
graphed and captures it again after `set_params`.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_ancestral import (STEPS, _check, _condition, _eps,  # noqa
                                  replay, setup)
from torch_twin import TINY, one_torch_thread  # noqa: F401
from tpu_diffusion.conditioning import guidance as jg
from tpu_diffusion.sampling import ancestral as ja
from tpu_diffusion_torch.cli import main as cli
from tpu_diffusion_torch.conditioning import guidance as pg
from tpu_diffusion_torch.conditioning.likelihoods import InPainting
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.models.unet import UNetModel, randomize_
from tpu_diffusion_torch.sampling import ancestral
from tpu_diffusion_torch.sampling.graph import GraphCache


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("update_rule", ["before", "after"])
def test_guidance_graphed_equals_eager(update_rule):
    """start_fraction 0.5 and one corrector at gamma 10: the graphed chain
    is the eager one, bit for bit, from one generator; the plain body
    replays for steps 24..12, the guided one for 11..1, and the guided
    step-0 body once."""
    model = randomize_(UNetModel(**TINY, dtype=torch.float32, device="cpu"),
                       _gen(0)).eval().requires_grad_(False)

    def eps(x, i):
        return model(x, i.float() / 1000)

    ddpm = DDPM.create(STEPS)
    lik = InPainting(patch_size=6, pad_value=-2.0)
    xT = torch.randn((2, 16, 16, 3), generator=_gen(3))
    cond = lik.sample(_gen(4), torch.tanh(xT))
    guidance = pg.ReconstructionGuidance(
        gamma=10.0, start_fraction=0.5, update_rule=update_rule,
        n_corrector=1, delta=0.1)
    graphs = GraphCache(model)
    want = ancestral.make_conditional_sampler(eps, ddpm, guidance, lik)(
        xT, cond, _gen(5))
    got = ancestral.make_conditional_sampler(eps, ddpm, guidance, lik,
                                             graphs=graphs)(
        xT, cond, _gen(5))
    assert torch.equal(got, want) and torch.isfinite(got).all()
    chain, = graphs.chains.values()
    assert chain.replays == {((False, True, False),): 13,
                             ((False, True, True),): 11,
                             ((False, False, True),): 1}


@pytest.mark.parametrize("update_rule", ["before", "after"])
def test_graphed_guidance_chain_matches_jax(setup, update_rule):
    """The graphed chain against the JAX jitted two-scan sampler, the JAX
    noise handed in, at gamma 1 and `test_guidance_chain_matches_jax`'s
    tolerance."""
    twins, x, xT = setup
    jeps, peps, jd, pd = _eps(twins, "uncond")
    jlik, plik, cond = _condition("inpainting", x)
    key = jax.random.PRNGKey(6)
    kw = dict(gamma=1.0, start_fraction=0.5, update_rule=update_rule)
    want = np.asarray(jax.jit(ja.make_conditional_sampler(
        jeps, jd, jg.ReconstructionGuidance(**kw), jlik))(key, xT, cond))
    got = ancestral.make_conditional_sampler(
        peps, pd, pg.ReconstructionGuidance(**kw), plik,
        graphs=GraphCache())(torch.from_numpy(xT), torch.from_numpy(cond),
                             noise=replay(key, STEPS, 2))
    _check(got, want)


def test_cli_guidance_sampler_stays_graphed():
    """`make_samplers` at the reconstruction-guidance config (every step
    guided at start_fraction 1.0): two bodies cached (the guided step and
    its noise-free step 0), the chain kept across calls, captured again
    after `set_params`, and equal to the eager sampler."""
    config = cli.get_config("mnist,inpainting,reconstruction_guidance")
    cli.apply_overrides(config, [
        "diffusion.num_steps=25", "network.dtype=float32",
        "network.num_channels=16", "network.num_head_channels=16"])
    assert config.conditioning.start_fraction == 1.0
    torch.manual_seed(0)
    parts = cli.build(config, torch.device("cpu"))
    model = randomize_(parts["model"], _gen(0)).eval()
    cond_sample, _ = cli.make_samplers(config, parts)
    eager_sample, _ = cli.make_samplers(config, parts, graphed=False)
    lik = parts["likelihood"]
    imgs = torch.tanh(torch.randn((2, 28, 28, 1), generator=_gen(1)))
    cond = lik.sample(_gen(2), imgs)
    xT = torch.randn(imgs.shape, generator=_gen(3))
    a = cond_sample(model, xT, cond, _gen(4))
    b = cond_sample(model, xT, cond, _gen(4))
    graphs = cond_sample.built["graphs"]
    chain, = graphs.chains.values()
    assert set(chain.bodies) == {((False, True, True),),
                                 ((False, False, True),)}
    assert torch.equal(a, b) and graphs.captures == 1
    assert torch.equal(a, eager_sample(model, xT, cond, _gen(4)))
    cli.set_params(model, {name: 0.9 * p.detach() for name, p
                           in model.named_parameters()})
    c = cond_sample(model, xT, cond, _gen(4))
    assert graphs.captures == 2 and not torch.equal(c, a)
    assert torch.equal(c, eager_sample(model, xT, cond, _gen(4)))
