"""DDIM samplers in PyTorch: plain, and with encoder-feature reuse.

Counterpart of `tpu_diffusion/sampling/ancestral.py` (`process_x0`,
`_ddim_per_step`, `_ddim_update`, `make_ddim_sampler`,
`make_cached_ddim_sampler`). The JAX package runs the chain as one
`lax.scan`; here it is a Python loop over precomputed per-step rows.
`eps_fn(x, i)` predicts noise for discrete steps `i` ([B] int32).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpu_diffusion_torch.core.schedules import DDPM

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def process_x0(x: torch.Tensor) -> torch.Tensor:
    """Clip the x0 prediction into the data range."""
    return torch.clamp(x, -1.0, 1.0)


def _ddim_per_step(ddpm: DDPM, num_steps: int, eta: float) -> np.ndarray:
    """Per-step DDIM coefficients in descending step order, float32:
    rows of [i, c_x0, c_dir, sqrt(abar), sigma, sr, srm1]."""
    if not 0 < num_steps <= ddpm.num_steps:
        raise ValueError(
            f"num_steps={num_steps} must be in [1, ddpm.num_steps="
            f"{ddpm.num_steps}] (a zero stride would run every DDIM step "
            f"at index 0)")
    stride = ddpm.num_steps // num_steps
    steps = np.arange(num_steps) * stride
    abar = np.asarray(ddpm.alphas_cumprod.numpy(), np.float64)[steps]
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    sigma = eta * np.sqrt((1 - abar_prev) / (1 - abar)
                          * (1 - abar / abar_prev))
    # xi_next = c_x0 * x0 + c_dir * (xi - sqrt(abar) x0) + sigma * noise
    c_x0 = np.sqrt(abar_prev)
    c_dir = (np.sqrt(np.maximum(1 - abar_prev - sigma ** 2, 0.0))
             / np.sqrt(1 - abar))
    # x0 = sr * xi - srm1 * eps
    sr = np.sqrt(1.0 / abar)
    srm1 = np.sqrt(1.0 / abar - 1.0)
    return np.stack([steps.astype(np.float64), c_x0, c_dir, np.sqrt(abar),
                     sigma, sr, srm1], axis=-1)[::-1].astype(np.float32)


def _ddim_update(xi: torch.Tensor, eps: torch.Tensor, row: np.ndarray,
                 eta: float, generator: torch.Generator | None):
    """One DDIM update from a coefficient row."""
    _, cx0, cdir, sab, sig, sr, srm1 = (float(v) for v in row)
    x0 = process_x0(sr * xi - srm1 * eps)
    xi_next = cx0 * x0 + cdir * (xi - sab * x0)
    if eta != 0.0:
        noise = torch.randn(xi.shape, generator=generator, dtype=xi.dtype,
                            device=xi.device)
        xi_next = xi_next + sig * noise
    return xi_next


def _step_index(xi: torch.Tensor, row: np.ndarray) -> torch.Tensor:
    return torch.full((xi.shape[0],), int(row[0]), dtype=torch.int32,
                      device=xi.device)


def make_ddim_sampler(eps_fn: EpsFn, ddpm: DDPM, num_steps: int = 100,
                      eta: float = 0.0) -> Callable:
    """Deterministic (eta=0) or stochastic DDIM over a strided step grid.

    Returns `sample(xT, generator=None) -> x0`; `generator` draws the eta>0
    noise on xT's device.
    """
    per_step = _ddim_per_step(ddpm, num_steps, eta)

    @torch.no_grad()
    def sample(xT: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        xi = xT
        for row in per_step:
            eps = eps_fn(xi, _step_index(xi, row))
            xi = _ddim_update(xi, eps, row, eta, generator)
        return process_x0(xi)

    return sample


def make_cached_ddim_sampler(encode_fn: Callable, decode_fn: Callable,
                             ddpm: DDPM, num_steps: int = 100,
                             eta: float = 0.0,
                             encoder_reuse: int = 2) -> Callable:
    """DDIM with encoder-feature reuse across adjacent steps ("Faster
    Diffusion", arXiv:2312.09608).

    `encode_fn(x, i) -> cache` refreshes the `(bottleneck, skips)` cache on
    the first step of each group of `encoder_reuse` steps;
    `decode_fn(x, i, cache) -> eps` runs middle and decoder on every step.
    A non-dividing `encoder_reuse` runs the remainder as a shorter first
    group at the high-noise end. `encoder_reuse=1` is exactly the plain
    DDIM sampler.
    """
    if encoder_reuse < 1:
        raise ValueError(f"encoder_reuse={encoder_reuse} must be >= 1")
    rem = num_steps % encoder_reuse
    per_step = _ddim_per_step(ddpm, num_steps, eta)
    groups = [per_step[:rem]] if rem else []
    groups += [per_step[s:s + encoder_reuse]
               for s in range(rem, num_steps, encoder_reuse)]

    @torch.no_grad()
    def sample(xT: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        xi = xT
        for rows in groups:
            cache = None
            for j, row in enumerate(rows):
                ib = _step_index(xi, row)
                if j == 0:
                    cache = encode_fn(xi, ib)
                eps = decode_fn(xi, ib, cache)
                xi = _ddim_update(xi, eps, row, eta, generator)
        return process_x0(xi)

    return sample
