"""The continuous VP-SDE and the discretized DDPM process in PyTorch.

Counterpart of `tpu_diffusion/core/schedules.py` (`VPSDE`,
`linear_vpsde_betas`, the discrete schedule builders, `bcast_right`,
`DDPM`). The builders are float64 numpy, as in the JAX package.
`VPSDE`'s methods take t as a tensor (or a number) and compute on its
device. The DDPM tables are built host-side in float64 numpy and stored as
float32 tensors on the CPU; `DDPM.to(device)` moves them, once per sampler,
to the device its steps run on.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class VPSDE:
    """Variance-preserving SDE with linear beta(t) = bm + (bd - bm) * t
    (image_diffusion/sde_diffusion.py:15-98).

    p(x_t | x_0) = N(x_t | scale(t) x_0, sigma(t)^2 I).
    """

    beta_min: float = 0.1
    beta_max: float = 20.0
    tmin: float = 1e-4
    tmax: float = 1.0

    def int_beta(self, t) -> torch.Tensor:
        """Integral of beta from 0 to t."""
        t = torch.as_tensor(t)
        return self.beta_min * t + (self.beta_max - self.beta_min) * t**2 / 2

    def beta(self, t) -> torch.Tensor:
        return self.beta_min + (self.beta_max - self.beta_min) * \
            torch.as_tensor(t)

    def scale(self, t) -> torch.Tensor:
        return torch.exp(-self.int_beta(t) / 2)

    def sigma(self, t) -> torch.Tensor:
        return torch.sqrt(1.0 - torch.exp(-self.int_beta(t)))

    def marginal_prob(self, x0: torch.Tensor, t
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of p(x_t | x_0), broadcast against x0."""
        s = bcast_right(self.scale(t), x0.ndim)
        sig = bcast_right(self.sigma(t), x0.ndim)
        return s * x0, sig

    def drift(self, x: torch.Tensor, t) -> torch.Tensor:
        """dx = drift dt + g dW (forward)."""
        return bcast_right(-0.5 * self.beta(t), x.ndim) * x

    def diffusion(self, t) -> torch.Tensor:
        return torch.sqrt(self.beta(t))

    def backward_drift(self, score: torch.Tensor, x: torch.Tensor, t
                       ) -> torch.Tensor:
        g2 = bcast_right(self.beta(t), x.ndim)
        return self.drift(x, t) - g2 * score

    def probability_flow_drift(self, score: torch.Tensor, x: torch.Tensor,
                               t) -> torch.Tensor:
        g2 = bcast_right(self.beta(t), x.ndim)
        return self.drift(x, t) - 0.5 * g2 * score

    def noise_score(self, xt: torch.Tensor, x0: torch.Tensor, t
                    ) -> torch.Tensor:
        """Score of the Gaussian marginal: grad log p(x_t | x_0)."""
        mean, sig = self.marginal_prob(x0, t)
        return (mean - xt) / sig**2

    def noise_input(self, generator: torch.Generator | None,
                    x0: torch.Tensor, t, eps: torch.Tensor | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample x_t | x_0 (with `eps`, or noise drawn from `generator`);
        returns (x_t, eps)."""
        mean, sig = self.marginal_prob(x0, t)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator,
                              dtype=x0.dtype, device=x0.device)
        return mean + sig * eps, eps

    def denoise_input(self, score: torch.Tensor, xt: torch.Tensor, t
                      ) -> torch.Tensor:
        s = bcast_right(self.scale(t), xt.ndim)
        sig = bcast_right(self.sigma(t), xt.ndim)
        return (xt + sig**2 * score) / s


def linear_vpsde_betas(num_steps: int, beta_min: float = 0.1,
                       beta_max: float = 20.0, tmin: float = 1e-5,
                       tmax: float = 1.0) -> np.ndarray:
    """Discretized VP-SDE betas: beta(t_i)/Ns on t_i = linspace(tmin, tmax, Ns)."""
    ts = np.linspace(tmin, tmax, num_steps, dtype=np.float64)
    return (beta_min + (beta_max - beta_min) * ts) / num_steps


def linear_betas(num_steps: int, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> np.ndarray:
    """Ho et al. (2020) linear schedule."""
    return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)


def cosine_alphas_cumprod(num_steps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule, as cumulative alpha-bar."""
    i = np.arange(num_steps + 1, dtype=np.float64)
    f = np.cos((i / num_steps + s) / (1 + s) * math.pi / 2) ** 2
    return f[1:] / f[0]


def hoogeboom_alphas_cumprod(num_steps: int, s: float = 1e-4,
                             exponent: float = 3.0,
                             clip_value: float = 0.001) -> np.ndarray:
    """Hoogeboom polynomial schedule, discrete form: alpha_bar(t) =
    (1 - t^exponent)^2 (1 - 2s) + s on t = linspace(0, 1, N), then the
    per-step ratios (with 1 prepended) clipped to [clip_value, 1] and
    re-accumulated (e3-diffusion's `clip_noise_schedule`)."""
    t = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    abar = (1.0 - t**exponent) ** 2 * (1 - 2 * s) + s
    abar_ext = np.concatenate([np.ones(1), abar])
    alphas = np.clip(abar_ext[1:] / abar_ext[:-1], clip_value, 1.0)
    return np.cumprod(alphas)


def sigmoid_betas(num_steps: int, beta_start: float = 1e-4,
                  beta_end: float = 0.02, tau: float = 6.0) -> np.ndarray:
    """sigmoid(linspace(-tau, tau, N)) * (beta_end - beta_start) +
    beta_start, with no renormalisation of the end points."""
    t = np.linspace(-tau, tau, num_steps, dtype=np.float64)
    return beta_start + (beta_end - beta_start) / (1.0 + np.exp(-t))


def quadratic_betas(num_steps: int, beta_start: float = 1e-4,
                    beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start**0.5, beta_end**0.5, num_steps,
                       dtype=np.float64) ** 2


def betas_from_alphas_cumprod(abar: np.ndarray, max_beta: float = 0.999
                              ) -> np.ndarray:
    abar = np.asarray(abar, np.float64)
    abar_prev = np.concatenate([np.ones((1,), abar.dtype), abar[:-1]])
    return np.clip(1.0 - abar / abar_prev, 0.0, max_beta)


def bcast_right(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a [B]-shaped (or scalar) value against an ndim-tensor."""
    if v.ndim == 0:
        return v
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


@dataclass(frozen=True)
class DDPM:
    """Discrete-time DDPM buffers (float32).

    Step `i` lies in [0, Ns); an eps-model trained on discrete steps is
    called with t = i / Ns. The methods take `i` as a [B] integer tensor on
    the tables' device (`to`).
    """

    num_steps: int
    tmin: float
    tmax: float
    ts: torch.Tensor
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @classmethod
    def create(cls, num_steps: int, betas: np.ndarray | None = None,
               tmin: float = 1e-5, tmax: float = 1.0) -> "DDPM":
        """Build from betas (default: the discretized VP-SDE)."""
        if betas is None:
            betas = linear_vpsde_betas(num_steps, tmin=tmin, tmax=tmax)
        betas = np.asarray(betas, np.float64)
        if not (np.all(betas > 0) and np.all(betas < 1)):
            # beta == 1 makes alpha_cumprod exactly 0 and the 1/abar tables
            # NaN (num_steps == 20 hits it: the last beta is exactly 1.0)
            raise ValueError(
                f"betas must lie in (0, 1); got range [{betas.min():.4g}, "
                f"{betas.max():.4g}] (the discretized VP-SDE schedule needs "
                f"num_steps > beta_max = 20)")
        ts = np.linspace(tmin, tmax, num_steps, dtype=np.float64)
        alphas = 1.0 - betas
        abar = np.cumprod(alphas)
        abar_prev = np.concatenate([np.ones((1,), abar.dtype), abar[:-1]])
        post_var = betas * (1.0 - abar_prev) / (1.0 - abar)

        def f(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        return cls(
            num_steps=num_steps, tmin=tmin, tmax=tmax,
            ts=f(ts),
            betas=f(betas),
            alphas=f(alphas),
            alphas_cumprod=f(abar),
            alphas_cumprod_prev=f(abar_prev),
            sqrt_alphas_cumprod=f(np.sqrt(abar)),
            sqrt_one_minus_alphas_cumprod=f(np.sqrt(1.0 - abar)),
            sqrt_recip_alphas_cumprod=f(np.sqrt(1.0 / abar)),
            sqrt_recipm1_alphas_cumprod=f(np.sqrt(1.0 / abar - 1.0)),
            posterior_variance=f(post_var),
            posterior_log_variance_clipped=f(
                np.log(np.clip(post_var, 1e-20, None))),
            posterior_mean_coef1=f(betas * np.sqrt(abar_prev) / (1.0 - abar)),
            posterior_mean_coef2=f(
                (1.0 - abar_prev) * np.sqrt(alphas) / (1.0 - abar)),
        )

    @classmethod
    def from_alphas_cumprod(cls, abar, tmin: float = 1e-5,
                            tmax: float = 1.0) -> "DDPM":
        return cls.create(len(abar), betas_from_alphas_cumprod(abar),
                          tmin=tmin, tmax=tmax)

    def to(self, device) -> "DDPM":
        """The same process with every table on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    # -- indexing ----------------------------------------------------------

    def _gather(self, buf: torch.Tensor, i: torch.Tensor,
                ndim: int) -> torch.Tensor:
        """buf[i] broadcast to an ndim-tensor (reference `extract`)."""
        return bcast_right(buf[i], ndim)

    def time_of(self, i: torch.Tensor) -> torch.Tensor:
        """Continuous time used by the eps-model: t = i / Ns."""
        return i.float() / self.num_steps

    # -- forward process ---------------------------------------------------

    def q_sample(self, x0: torch.Tensor, i: torch.Tensor,
                 noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample x_i ~ q(x_i | x_0); returns (x_i, eps). eps is `noise`
        when a tensor is given, else drawn with `torch.randn` on
        `generator`."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                dtype=x0.dtype, device=x0.device)
        return self.q_sample_with_noise(x0, noise, i), noise

    def q_sample_with_noise(self, x0: torch.Tensor, eps: torch.Tensor,
                            i: torch.Tensor) -> torch.Tensor:
        return (self._gather(self.sqrt_alphas_cumprod, i, x0.ndim) * x0
                + self._gather(self.sqrt_one_minus_alphas_cumprod, i, x0.ndim)
                * eps)

    # -- conversions -------------------------------------------------------

    def predict_start_from_noise(self, xi: torch.Tensor, i: torch.Tensor,
                                 eps: torch.Tensor) -> torch.Tensor:
        return (self._gather(self.sqrt_recip_alphas_cumprod, i, xi.ndim) * xi
                - self._gather(self.sqrt_recipm1_alphas_cumprod, i, xi.ndim)
                * eps)

    def predict_noise_from_start(self, xi: torch.Tensor, i: torch.Tensor,
                                 x0: torch.Tensor) -> torch.Tensor:
        return ((self._gather(self.sqrt_recip_alphas_cumprod, i, xi.ndim) * xi
                 - x0)
                / self._gather(self.sqrt_recipm1_alphas_cumprod, i, xi.ndim))

    def score_from_noise(self, eps: torch.Tensor,
                         i: torch.Tensor) -> torch.Tensor:
        """Score = -eps / sigma_i with sigma_i = sqrt(1 - alpha_bar_i)."""
        return -eps / self._gather(self.sqrt_one_minus_alphas_cumprod, i,
                                   eps.ndim)

    def score_from_x0(self, x0: torch.Tensor,
                      i: torch.Tensor) -> torch.Tensor:
        """The corrector's score surrogate: -x0 / sqrt(1 - abar_i)."""
        return (-self._gather(1.0 / self.sqrt_one_minus_alphas_cumprod, i,
                              x0.ndim) * x0)

    # -- reverse process ---------------------------------------------------

    def q_posterior(self, x0: torch.Tensor, xi: torch.Tensor,
                    i: torch.Tensor):
        """(mean, variance, log variance) of q(x_{i-1} | x_i, x_0)."""
        mean = (self._gather(self.posterior_mean_coef1, i, xi.ndim) * x0
                + self._gather(self.posterior_mean_coef2, i, xi.ndim) * xi)
        var = self._gather(self.posterior_variance, i, xi.ndim)
        logvar = self._gather(self.posterior_log_variance_clipped, i, xi.ndim)
        return mean, var, logvar

    def p_mean_variance(self, x0_pred: torch.Tensor, xi: torch.Tensor,
                        i: torch.Tensor):
        return self.q_posterior(x0_pred, xi, i)
