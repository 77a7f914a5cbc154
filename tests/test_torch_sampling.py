"""The port's DDIM chains against the JAX samplers, from one shared xT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import jax_kernels, make_twins
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.sampling import ancestral as jax_samplers
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.sampling.ancestral import (make_cached_ddim_sampler,
                                                    make_ddim_sampler)

STEPS = 10  # with K=3: a head group of 1, then 3 groups of 3
# fp32 on both sides: the 1e-4 per-forward agreement of test_torch_unet,
# carried through 10 DDIM updates whose coefficients (sr up to ~6 at the
# high-noise end) amplify it; 2e-4 holds with margin
ATOL = 2e-4


def _fns(model, ddpm_steps, jax_params=None):
    """eps / encode / decode closures over either model; t = i / Ns."""
    if jax_params is not None:
        def call(x, i, **kw):
            return model.apply(jax_params, x,
                               i.astype(jnp.float32) / ddpm_steps, **kw)
    else:
        def call(x, i, **kw):
            return model(x, i.float() / ddpm_steps, **kw)
    return (lambda x, i: call(x, i),
            lambda x, i: call(x, i, mode="encode"),
            lambda x, i, c: call(x, i, mode="decode", cache=c))


@pytest.fixture(scope="module")
def twins():
    mp = pytest.MonkeyPatch()
    try:
        with jax_kernels("xla", mp):
            jm, params, port = make_twins("xla", seed=7)
            xT = np.random.default_rng(8).standard_normal(
                (2, 16, 16, 3)).astype(np.float32)
            eps, enc, dec = _fns(jm, 1000, params)
            ddpm = JaxDDPM.create(1000)
            key = jax.random.PRNGKey(0)
            want = {
                1: np.asarray(jax.jit(jax_samplers.make_ddim_sampler(
                    eps, ddpm, num_steps=STEPS))(key, xT)),
                3: np.asarray(jax.jit(jax_samplers.make_cached_ddim_sampler(
                    enc, dec, ddpm, num_steps=STEPS, encoder_reuse=3))(
                        key, xT)),
            }
    finally:
        mp.undo()
    return port, torch.from_numpy(xT), want


def test_ddim_k1_matches_jax(twins):
    port, xT, want = twins
    eps, _, _ = _fns(port, 1000)
    got = make_ddim_sampler(eps, DDPM.create(1000), num_steps=STEPS)(xT)
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want[1], atol=ATOL, rtol=0)


def test_cached_ddim_k3_matches_jax(twins):
    port, xT, want = twins
    _, enc, dec = _fns(port, 1000)
    got = make_cached_ddim_sampler(enc, dec, DDPM.create(1000),
                                   num_steps=STEPS, encoder_reuse=3)(xT)
    np.testing.assert_allclose(got.numpy(), want[3], atol=ATOL, rtol=0)
    # reuse changes the chain: K=3 is not K=1
    assert np.abs(want[3] - want[1]).max() > 10 * ATOL


def test_cached_k1_is_plain_ddim(twins):
    port, xT, _ = twins
    eps, enc, dec = _fns(port, 1000)
    ddpm = DDPM.create(1000)
    plain = make_ddim_sampler(eps, ddpm, num_steps=STEPS)(xT)
    cached = make_cached_ddim_sampler(enc, dec, ddpm, num_steps=STEPS,
                                      encoder_reuse=1)(xT)
    assert torch.equal(plain, cached)


def test_stochastic_ddim_follows_its_generator(twins):
    """eta > 0 draws its noise from the caller's generator: one seed gives
    one chain, and K=1 cached still equals plain DDIM."""
    port, xT, _ = twins
    eps, enc, dec = _fns(port, 1000)
    ddpm = DDPM.create(1000)
    plain = make_ddim_sampler(eps, ddpm, num_steps=4, eta=1.0)
    cached = make_cached_ddim_sampler(enc, dec, ddpm, num_steps=4, eta=1.0,
                                      encoder_reuse=1)
    a = plain(xT, torch.Generator().manual_seed(0))
    b = cached(xT, torch.Generator().manual_seed(0))
    c = plain(xT, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_cached_sampler_rejects_bad_reuse():
    with pytest.raises(ValueError, match="encoder_reuse"):
        make_cached_ddim_sampler(None, None, DDPM.create(100), 10,
                                 encoder_reuse=0)
