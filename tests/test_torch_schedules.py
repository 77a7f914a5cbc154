"""The port's DDPM tables and DDIM coefficient rows against the JAX package."""

import numpy as np
import pytest
import torch

from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.sampling.ancestral import _ddim_per_step as jax_per_step
from tpu_diffusion_torch.core.schedules import DDPM, bcast_right
from tpu_diffusion_torch.sampling.ancestral import _ddim_per_step

TABLES = ("ts", "betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.mark.parametrize("num_steps", [1000, 100, 21])
def test_ddpm_tables_match_jax(num_steps):
    port, ref = DDPM.create(num_steps), JaxDDPM.create(num_steps)
    for name in TABLES:
        got = getattr(port, name)
        assert got.dtype == torch.float32, name
        # both round the same float64 numpy table to fp32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-7, rtol=0, err_msg=name)


@pytest.mark.parametrize("num_steps,eta", [(100, 0.0), (10, 0.0), (10, 0.5),
                                           (7, 1.0)])
def test_ddim_rows_match_jax(num_steps, eta):
    got = _ddim_per_step(DDPM.create(1000), num_steps, eta)
    want = np.asarray(jax_per_step(JaxDDPM.create(1000), num_steps, eta))
    assert got.shape == want.shape == (num_steps, 7)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_beta_guard_raises_at_20_steps():
    with pytest.raises(ValueError, match="betas must lie in"):
        DDPM.create(20)


def test_ddim_rejects_bad_step_count():
    with pytest.raises(ValueError, match="num_steps"):
        _ddim_per_step(DDPM.create(100), 0, 0.0)
    with pytest.raises(ValueError, match="num_steps"):
        _ddim_per_step(DDPM.create(100), 101, 0.0)


def test_bcast_right():
    v = torch.arange(3.0)
    assert bcast_right(v, 4).shape == (3, 1, 1, 1)
    assert bcast_right(torch.tensor(2.0), 4).shape == ()
