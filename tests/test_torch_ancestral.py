"""The port's ancestral samplers against the JAX package's, chain by chain.

Both sides start from one xT and one condition made with numpy; the port's
noise source replays the JAX key tree (`_reverse_scan` splits (key, sk) per
step; a step splits sk into (k1, k2) or (k1, k2, k3); k1 draws the posterior
noise, fold_in(k2, j) the j-th corrector noise, k3 the replacement's
q_sample noise), so the two chains see the same noise. Tiny UNet twins (16
channels, dense attention on both sides), DDPM.create(25), fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import jax_kernels, make_twins, one_torch_thread  # noqa: F401
from tpu_diffusion.conditioning import guidance as jg
from tpu_diffusion.conditioning import likelihoods as jl
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.losses.ddpm import make_eps_model as jax_eps_model
from tpu_diffusion.sampling import ancestral as ja
from tpu_diffusion_torch.conditioning import guidance as pg
from tpu_diffusion_torch.conditioning import likelihoods as pl
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.losses.ddpm import get_loss_function, make_eps_model
from tpu_diffusion_torch.sampling import ancestral as pa

STEPS = 25  # with K=3: a head group of 1 step, then 8 groups of 3
# fp32 on both sides: the 1e-4 per-forward agreement of test_torch_unet,
# carried through 25 ancestral steps whose x0 coefficients (up to ~6 at the
# high-noise end) amplify it
ATOL = 2e-4
PATCH = 6  # on 16x16 images: the patch origin is pinned at the margin, 5


def replay(key, num_steps, split):
    """A noise source that draws what the JAX sampler draws from `key`."""
    keys = {}
    for i in range(num_steps - 1, -1, -1):
        key, sk = jax.random.split(key)
        keys[i] = sk

    def draw(like, kind, i, j=0):
        k = keys[i]
        if split > 1:
            ks = jax.random.split(k, split)
            k = {"posterior": lambda: ks[0],
                 "corrector": lambda: jax.random.fold_in(ks[1], j),
                 "replace": lambda: ks[2]}[kind]()
        return torch.from_numpy(np.array(jax.random.normal(
            k, tuple(like.shape), jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    try:
        with jax_kernels("xla", mp):
            twins = {
                "uncond": make_twins("xla", seed=21, attention_impl="xla"),
                "amortized": make_twins("xla", seed=22, attention_impl="xla",
                                        in_channels=6),
            }
    finally:
        mp.undo()
    rng = np.random.default_rng(23)
    x = np.clip(rng.standard_normal((2, 16, 16, 3)), -1, 1).astype(
        np.float32)
    xT = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return twins, x, xT.copy()


def _eps(twins, name):
    jm, params, port = twins[name]
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    return (jax_eps_model(lambda x, t: jm.apply(params, x, t), jd),
            make_eps_model(port, pd), jd, pd)


def _condition(lik_name, x, key=jax.random.PRNGKey(5)):
    jlik = jl.get_likelihood(lik_name)(patch_size=PATCH)
    plik = pl.get_likelihood(lik_name)(patch_size=PATCH)
    return jlik, plik, np.array(jlik.sample(key, jnp.asarray(x)))


def _check(got, want):
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_prior_chain_matches_jax(setup):
    twins, _, xT = setup
    jeps, peps, jd, pd = _eps(twins, "uncond")
    key = jax.random.PRNGKey(1)
    want = np.asarray(jax.jit(ja.make_prior_sampler(jeps, jd))(key, xT))
    got = pa.make_prior_sampler(peps, pd)(torch.from_numpy(xT),
                                          noise=replay(key, STEPS, 1))
    _check(got, want)


@pytest.mark.parametrize("n_corrector", [0, 1])
def test_amortized_chain_matches_jax(setup, n_corrector):
    twins, x, xT = setup
    jeps, peps, jd, pd = _eps(twins, "amortized")
    jlik, plik, cond = _condition("inpainting", x)
    key = jax.random.PRNGKey(2 + n_corrector)
    want = np.asarray(jax.jit(ja.make_conditional_sampler(
        jeps, jd, jg.Amortized(n_corrector=n_corrector), jlik))(
            key, xT, cond))
    got = pa.make_conditional_sampler(
        peps, pd, pg.Amortized(n_corrector=n_corrector), plik)(
            torch.from_numpy(xT), torch.from_numpy(cond),
            noise=replay(key, STEPS, 2))
    _check(got, want)


def _enc_dec(call):
    return (lambda x, i: call(x, i, mode="encode"),
            lambda x, i, c: call(x, i, mode="decode", cache=c))


def test_cached_amortized_k3_matches_jax(setup):
    twins, x, xT = setup
    jm, params, port = twins["amortized"]
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    jlik, plik, cond = _condition("inpainting", x)
    key = jax.random.PRNGKey(4)
    jenc, jdec = _enc_dec(lambda x, i, **kw: jm.apply(
        params, x, i.astype(jnp.float32) / STEPS, **kw))
    penc, pdec = _enc_dec(lambda x, i, **kw: port(x, i.float() / STEPS,
                                                  **kw))
    want = np.asarray(jax.jit(ja.make_cached_amortized_sampler(
        jenc, jdec, jd, jg.Amortized(), jlik, encoder_reuse=3))(
            key, xT, cond))
    got = pa.make_cached_amortized_sampler(
        penc, pdec, pd, pg.Amortized(), plik, encoder_reuse=3)(
            torch.from_numpy(xT), torch.from_numpy(cond),
            noise=replay(key, STEPS, 2))
    _check(got, want)
    groups = pa.reuse_groups(range(STEPS - 1, -1, -1), 3)
    assert [list(g) for g in groups[:2]] == [[24], [23, 22, 21]]
    assert len(groups) == 9 and sum(len(g) for g in groups) == STEPS


def test_cached_k1_is_the_plain_amortized_sampler(setup):
    twins, x, xT = setup
    _, _, port = twins["amortized"]
    _, peps, _, pd = _eps(twins, "amortized")
    _, plik, cond = _condition("inpainting", x)
    penc, pdec = _enc_dec(lambda x, i, **kw: port(x, i.float() / STEPS,
                                                  **kw))
    xT, cond = torch.from_numpy(xT), torch.from_numpy(cond)
    plain = pa.make_conditional_sampler(peps, pd, pg.Amortized(), plik)(
        xT, cond, torch.Generator().manual_seed(0))
    cached = pa.make_cached_amortized_sampler(
        penc, pdec, pd, pg.Amortized(), plik, encoder_reuse=1)(
            xT, cond, torch.Generator().manual_seed(0))
    other = pa.make_conditional_sampler(peps, pd, pg.Amortized(), plik)(
        xT, cond, torch.Generator().manual_seed(1))
    assert torch.equal(plain, cached) and not torch.equal(plain, other)
    with pytest.raises(ValueError, match="encoder_reuse"):
        pa.make_cached_amortized_sampler(penc, pdec, pd, pg.Amortized(),
                                         plik, encoder_reuse=0)


@pytest.mark.parametrize("update_rule", ["before", "after"])
def test_guidance_chain_matches_jax(setup, update_rule):
    twins, x, xT = setup
    jeps, peps, jd, pd = _eps(twins, "uncond")
    jlik, plik, cond = _condition("inpainting", x)
    key = jax.random.PRNGKey(6)
    # gamma 1, not the config's 10: each guided step adds gamma * alpha *
    # (1 - alpha) times a gradient of O(10), which at gamma 10 amplifies the
    # fp32 rounding of the two sides to ~8e-4 over the 12 guided steps
    # (1.5e-5 at gamma 1); the card runs gamma 10 (chip_smoke.py)
    kw = dict(gamma=1.0, start_fraction=0.5, update_rule=update_rule)
    want = np.asarray(jax.jit(ja.make_conditional_sampler(
        jeps, jd, jg.ReconstructionGuidance(**kw), jlik))(key, xT, cond))
    got = pa.make_conditional_sampler(
        peps, pd, pg.ReconstructionGuidance(**kw), plik)(
            torch.from_numpy(xT), torch.from_numpy(cond),
            noise=replay(key, STEPS, 2))
    _check(got, want)


def test_guidance_gradient_matches_jax_grad(setup):
    twins, x, _ = setup
    jeps, peps, jd, pd = _eps(twins, "uncond")
    jlik, plik, cond = _condition("inpainting", x)
    xi = np.random.default_rng(24).standard_normal(x.shape).astype(
        np.float32) * 0.3 + x
    i = 3
    jx0 = ja.make_x0_model(jeps, jd)
    ib = jnp.full((2,), i, jnp.int32)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jlik.loss(
        jx0(v, ib), jnp.asarray(cond)))))(jnp.asarray(xi)))
    got = pa.guidance_gradient(
        pa.make_x0_model(peps, pd), plik, torch.from_numpy(cond),
        torch.from_numpy(xi), torch.full((2,), i, dtype=torch.long))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("noise", [True, False])
def test_replacement_chain_matches_jax(setup, noise):
    twins, x, xT = setup
    jeps, peps, jd, pd = _eps(twins, "uncond")
    jlik, plik, cond = _condition("outpainting", x)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(ja.make_conditional_sampler(
        jeps, jd, jg.Replacement(noise=noise, start_fraction=0.8), jlik))(
            key, xT, cond))
    got = pa.make_conditional_sampler(
        peps, pd, pg.Replacement(noise=noise, start_fraction=0.8), plik)(
            torch.from_numpy(xT), torch.from_numpy(cond),
            noise=replay(key, STEPS, 3))
    _check(got, want)


def test_replacement_rejects_hyperresolution():
    with pytest.raises(NotImplementedError, match="Painting likelihood"):
        pa.make_conditional_sampler(None, DDPM.create(STEPS),
                                    pg.Replacement(),
                                    pl.HyperResolution())


def test_ddpm_methods_match_jax():
    jd, pd = JaxDDPM.create(STEPS), DDPM.create(STEPS)
    rng = np.random.default_rng(25)
    x0, xi, eps = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
                   for _ in range(3))
    i = np.array([0, 11, 24])
    ji, pi = jnp.asarray(i, jnp.int32), torch.from_numpy(i)
    tx = [torch.from_numpy(a) for a in (x0, xi, eps)]
    pairs = [
        (jd.q_sample_with_noise(x0, eps, ji), pd.q_sample_with_noise(
            tx[0], tx[2], pi)),
        (jd.predict_start_from_noise(xi, ji, eps),
         pd.predict_start_from_noise(tx[1], pi, tx[2])),
        (jd.predict_noise_from_start(xi, ji, x0),
         pd.predict_noise_from_start(tx[1], pi, tx[0])),
        (jd.score_from_noise(eps, ji), pd.score_from_noise(tx[2], pi)),
        (jd.score_from_x0(x0, ji), pd.score_from_x0(tx[0], pi)),
        (jd.time_of(ji), pd.time_of(pi)),
        *zip(jd.q_posterior(x0, xi, ji), pd.q_posterior(tx[0], tx[1], pi)),
        *zip(jd.p_mean_variance(x0, xi, ji),
             pd.p_mean_variance(tx[0], tx[1], pi)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    xs, noise = pd.q_sample(tx[0], pi, noise=tx[2])
    assert torch.equal(noise, tx[2])
    assert torch.equal(xs, pd.q_sample_with_noise(tx[0], tx[2], pi))
    drawn, n1 = pd.q_sample(tx[0], pi, generator=torch.Generator().manual_seed(0))
    _, n2 = pd.q_sample(tx[0], pi, generator=torch.Generator().manual_seed(0))
    assert torch.equal(n1, n2) and drawn.shape == tx[0].shape
    moved = pd.to("meta")
    assert moved.alphas.device.type == "meta" and moved.num_steps == STEPS


def test_loss_function_gives_the_eps_adapter():
    seen = []
    loss_fn, eps = get_loss_function(lambda x, t: seen.append(t) or x,
                                     DDPM.create(STEPS),
                                     pg.ReconstructionGuidance())
    eps(torch.zeros(2), torch.tensor([5, 10]))
    torch.testing.assert_close(seen[0], torch.tensor([0.2, 0.4]))
    # the loss beside it is the plain DDPM objective: with the network
    # returning x_i, mean((x_i - eps)^2) for the given draws
    x = torch.ones(2, 4, 4, 1)
    i, noise = torch.tensor([5, 10]), torch.full((2, 4, 4, 1), 0.5)
    ddpm = DDPM.create(STEPS)
    want = ((ddpm.q_sample_with_noise(x, noise, i) - noise) ** 2).mean()
    torch.testing.assert_close(loss_fn(None, x, i=i, noise=noise), want)
    with pytest.raises(ValueError, match="likelihood"):
        get_loss_function(lambda x, t: x, ddpm, pg.Amortized())
