"""The port's likelihoods, conditioning configs and image metrics against the
JAX package, on the CPU in fp32, from inputs made with numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.conditioning import guidance as jax_guidance
from tpu_diffusion.conditioning import likelihoods as jax_lik
from tpu_diffusion.eval import metrics as jax_metrics
from tpu_diffusion.utils.config import get_config as jax_get_config
from tpu_diffusion_torch.conditioning import guidance, likelihoods
from tpu_diffusion_torch.eval import metrics
from tpu_diffusion_torch.utils.config import get_config


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32)


def _jax_origins(key, batch, height, width, patch, margin=5):
    """The patch origins the JAX `_patch_mask` draws from `key`."""
    kh, kw = jax.random.split(key)

    def draw(k, size):
        lo, hi = margin, size - patch - margin
        return np.array(jax.random.randint(k, (batch,), lo,
                                           max(hi, lo + 1)))

    return draw(kh, height), draw(kw, width)


@pytest.mark.parametrize("name", ["inpainting", "outpainting"])
@pytest.mark.parametrize("shape,patch", [((4, 28, 28, 1), 14),
                                         ((3, 32, 40, 3), 12)])
def test_painting_matches_jax(name, shape, patch):
    x = _images(patch, shape)
    key = jax.random.PRNGKey(patch + len(name))
    jl = jax_lik.get_likelihood(name)(patch_size=patch, pad_value=-2.0)
    pl = likelihoods.get_likelihood(name)(patch_size=patch, pad_value=-2.0)
    want = np.asarray(jl.sample(key, jnp.asarray(x)))
    origins = _jax_origins(key, shape[0], shape[1], shape[2], patch)
    xt = torch.from_numpy(x)
    cond = pl.sample(None, xt, origins=origins)
    np.testing.assert_array_equal(cond.numpy(), want)
    assert (cond == -2.0).any() and (cond != -2.0).any()
    np.testing.assert_array_equal(pl.none_like(xt).numpy(),
                                  np.asarray(jl.none_like(jnp.asarray(x))))
    np.testing.assert_array_equal(pl.observed_mask(cond).numpy(),
                                  np.asarray(jl.observed_mask(want)))
    pred = _images(patch + 1, shape)
    np.testing.assert_allclose(
        pl.loss(torch.from_numpy(pred), cond).numpy(),
        np.asarray(jl.loss(jnp.asarray(pred), want)), rtol=1e-5, atol=1e-5)
    # origins drawn from a torch generator lie inside the margins
    gen = torch.Generator().manual_seed(0)
    drawn = pl.sample(gen, xt)
    blank = (drawn == -2.0) if name == "inpainting" else (drawn != -2.0)
    rows = blank[..., 0].any(dim=2)
    assert rows.sum(dim=1).eq(patch).all()
    first = rows.float().argmax(dim=1)
    assert (first >= 5).all() and (first + patch <= shape[1] - 5).all()


def test_patch_margin_raises():
    x = torch.zeros((2, 28, 28, 1))
    with pytest.raises(ValueError, match="does not fit"):
        likelihoods.InPainting(patch_size=20).sample(None, x)
    with pytest.raises(ValueError, match="does not fit"):
        jax_lik.InPainting(patch_size=20).sample(jax.random.PRNGKey(0),
                                                 jnp.zeros((2, 28, 28, 1)))


def test_hyperresolution_matches_jax():
    x = _images(3, (2, 64, 64, 3))
    jl = jax_lik.HyperResolution(target_height=16, target_width=16)
    pl = likelihoods.HyperResolution(target_height=16, target_width=16)
    want = np.asarray(jl.sample(jax.random.PRNGKey(0), jnp.asarray(x)))
    xt = torch.from_numpy(x)
    cond = pl.sample(None, xt)
    np.testing.assert_allclose(cond.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(pl.none_like(xt).numpy(), 0.0)
    pred = _images(4, (2, 64, 64, 3))
    low = np.asarray(jl.downsample(jnp.asarray(x)))
    for c_j, c_p in ((want, cond), (low, pl.downsample(xt))):
        # a full-size condition, and a 16x16 one the loss upsamples first
        np.testing.assert_allclose(
            pl.loss(torch.from_numpy(pred), c_p).numpy(),
            np.asarray(jl.loss(jnp.asarray(pred), jnp.asarray(c_j))),
            atol=1e-5, rtol=1e-5)


def test_resize_antialiases_when_downsampling():
    """`jax.image.resize(..., "bilinear")` widens its kernel when
    downsampling: `antialias=True` matches it, plain bilinear does not."""
    x = _images(5, (2, 64, 64, 3))
    want = np.array(jax.image.resize(jnp.asarray(x), (2, 16, 16, 3),
                                     "bilinear"))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        likelihoods.resize_bilinear(xt, 16, 16).numpy(), want, atol=1e-5)
    plain = F.interpolate(xt.permute(0, 3, 1, 2), size=(16, 16),
                          mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1)
    assert np.abs(plain.numpy() - want).max() > 0.1
    up = np.asarray(jax.image.resize(jnp.asarray(want), (2, 64, 64, 3),
                                     "bilinear"))
    np.testing.assert_allclose(
        likelihoods.resize_bilinear(torch.from_numpy(want), 64, 64).numpy(),
        up, atol=1e-5)


@pytest.mark.parametrize("name", ["amortized", "reconstruction_guidance",
                                  "replacement"])
def test_conditioning_from_config_matches_jax(name):
    spec = f"flowers,inpainting,{name}"
    want = jax_guidance.get_conditioning(name).from_configdict(
        jax_get_config(spec).conditioning)
    got = guidance.get_conditioning(name).from_configdict(
        get_config(spec).conditioning)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.delta = 1.0


@pytest.mark.parametrize("name", ["inpainting", "outpainting",
                                  "hyperresolution"])
def test_likelihood_from_config_matches_jax(name):
    spec = f"mnist,{name},amortized"
    want = jax_lik.get_likelihood(name).from_configdict(
        jax_get_config(spec).likelihood)
    got = likelihoods.get_likelihood(name).from_configdict(
        get_config(spec).likelihood)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_factories_reject_unknown_names():
    with pytest.raises(NotImplementedError):
        likelihoods.get_likelihood("deblur")
    with pytest.raises(NotImplementedError):
        guidance.get_conditioning("classifier")


def test_metrics_match_jax():
    """Per-sample MSE/PSNR/SSIM and the batch statistics, on an even batch:
    `jnp.median` averages the two middle values (`torch.median` returns the
    lower) and `jnp.std` is the population std."""
    a = _images(6, (4, 16, 16, 3))
    b = np.clip(a + 0.3 * _images(7, (4, 16, 16, 3))
                * np.arange(1, 5, dtype=np.float32)[:, None, None, None],
                -1, 1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for fn in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(getattr(metrics, fn)(at, bt).numpy(),
                                   np.asarray(getattr(jax_metrics, fn)(ja, jb)),
                                   atol=1e-5, rtol=1e-5)
    got = {k: float(v) for k, v in metrics.eval_statistics(at, bt).items()}
    want = {k: float(v) for k, v in
            jax_metrics.eval_statistics(ja, jb).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5)
    vals = metrics.mse(at, bt)
    assert got["mse_median"] != pytest.approx(float(torch.median(vals)))
    assert got["mse_std"] != pytest.approx(float(torch.std(vals)))
