"""Closed-form Gaussian diffusion conditioning (the h-transform math), in
PyTorch.

Counterpart of `tpu_diffusion/core/analytic.py` (the reference's
`notebooks/conditioning_with_analytic_htransform.ipynb`): for Gaussian data
p0 = N(mu0, var0) under the VP-SDE, the marginal, its score, the posterior
of x0 given x_t, and the exact conditional score for an observation
y = x0 + noise by Bayes' rule, the ground truth that reconstruction
guidance approximates. Diagonal covariances only; every argument is a
tensor (or a number) that broadcasts against the others.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_diffusion_torch.core.schedules import VPSDE


def marginal_params(sde: VPSDE, mu0, var0, t
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p_t = N(s(t) mu0, s(t)^2 var0 + sigma(t)^2) for Gaussian p0."""
    s = sde.scale(t)
    sig2 = sde.sigma(t) ** 2
    return s * mu0, s**2 * var0 + sig2


def marginal_score(sde: VPSDE, mu0, var0, x, t) -> torch.Tensor:
    """grad_x log p_t(x), exact."""
    mean, var = marginal_params(sde, mu0, var0, t)
    return (mean - x) / var


def posterior_x0_given_xt(sde: VPSDE, mu0, var0, xt, t
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p(x0 | xt) = N(mu_post, var_post), exact for Gaussian p0."""
    s = sde.scale(t)
    sig2 = sde.sigma(t) ** 2
    prec = 1.0 / var0 + s**2 / sig2
    var_post = 1.0 / prec
    mu_post = var_post * (mu0 / var0 + s * xt / sig2)
    return mu_post, var_post


def conditional_score(sde: VPSDE, mu0, var0, y, obs_var, xt,
                      t) -> torch.Tensor:
    """Exact conditional score grad_x log p_t(x | y) for y = x0 + eps,
    eps ~ N(0, obs_var): condition p0 on y (a Gaussian with
    var_c = (1/var0 + 1/obs_var)^-1, mu_c = var_c (mu0/var0 + y/obs_var)),
    then diffuse."""
    var_c = 1.0 / (1.0 / var0 + 1.0 / obs_var)
    mu_c = var_c * (mu0 / var0 + y / obs_var)
    return marginal_score(sde, mu_c, var_c, xt, t)


def guidance_term(sde: VPSDE, mu0, var0, y, obs_var, xt,
                  t) -> torch.Tensor:
    """The h-transform correction, conditional minus unconditional score:
    grad_x log p(y | x_t), what reconstruction guidance approximates."""
    return (conditional_score(sde, mu0, var0, y, obs_var, xt, t)
            - marginal_score(sde, mu0, var0, xt, t))
