"""The discretized DDPM process in PyTorch.

Counterpart of `tpu_diffusion/core/schedules.py` (`linear_vpsde_betas`,
`bcast_right`, `DDPM`). The tables are built host-side in float64 numpy and
stored as float32 tensors on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def linear_vpsde_betas(num_steps: int, beta_min: float = 0.1,
                       beta_max: float = 20.0, tmin: float = 1e-5,
                       tmax: float = 1.0) -> np.ndarray:
    """Discretized VP-SDE betas: beta(t_i)/Ns on t_i = linspace(tmin, tmax, Ns)."""
    ts = np.linspace(tmin, tmax, num_steps, dtype=np.float64)
    return (beta_min + (beta_max - beta_min) * ts) / num_steps


def bcast_right(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a [B]-shaped (or scalar) value against an ndim-tensor."""
    if v.ndim == 0:
        return v
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


@dataclass(frozen=True)
class DDPM:
    """Discrete-time DDPM buffers (float32, CPU).

    Step `i` lies in [0, Ns); an eps-model trained on discrete steps is
    called with t = i / Ns. The samplers read the tables they need once,
    before their loop.
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
