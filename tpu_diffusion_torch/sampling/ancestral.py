"""Ancestral DDPM samplers (prior and three conditioning modes) and DDIM.

Counterpart of `tpu_diffusion/sampling/ancestral.py`. The JAX package runs
each chain as one `lax.scan`; here it is a Python loop over the steps.
`eps_fn(x, i)` predicts noise for discrete steps `i` ([B] integers); an
amortized model also receives the condition as extra channels.

Noise: the ancestral samplers draw every random tensor through one noise
source, `noise(like, kind, i, j)` -> standard normal noise of `like`'s shape,
type and device, where `kind` is "posterior" (the step at i), "corrector"
(corrector iterate j at step i) or "replace" (the replacement sampler's
q_sample at step i). The default, `randn_noise(generator)`, draws with
`torch.randn` on the caller's generator in call order; a test passes a
source that replays the JAX key tree. No noise is drawn for step 0, where
the JAX package multiplies it by 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from tpu_diffusion_torch.conditioning.guidance import (Amortized,
                                                       Conditioning,
                                                       ReconstructionGuidance,
                                                       Replacement)
from tpu_diffusion_torch.conditioning.likelihoods import Likelihood, Painting
from tpu_diffusion_torch.core.schedules import DDPM

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[..., torch.Tensor]


def process_x0(x: torch.Tensor) -> torch.Tensor:
    """Clip the x0 prediction into the data range."""
    return torch.clamp(x, -1.0, 1.0)


def randn_noise(generator: torch.Generator | None = None) -> NoiseFn:
    """The default noise source: `torch.randn` on `generator` (on the
    sampled tensor's device), in call order."""
    def draw(like: torch.Tensor, kind: str, i: int, j: int = 0):
        del kind, i, j
        return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                           device=like.device)
    return draw


def make_x0_model(eps_fn: EpsFn, ddpm: DDPM) -> Callable:
    def x0_model(xi: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return process_x0(ddpm.predict_start_from_noise(xi, i,
                                                        eps_fn(xi, i)))
    return x0_model


def amortized_eps_fn(eps_fn: EpsFn, condition: torch.Tensor) -> EpsFn:
    """Concat the condition as extra channels before the eps model."""
    def fn(xi: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return eps_fn(torch.cat([xi, condition], dim=-1), i)
    return fn


def _batched(i: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((like.shape[0],), i, dtype=torch.long,
                      device=like.device)


def _posterior_step(draw: NoiseFn, ddpm: DDPM, x0_pred: torch.Tensor,
                    xi: torch.Tensor, ib: torch.Tensor, i: int):
    """One ancestral step: posterior mean + sigma * noise (none at i == 0)."""
    mean, _, logvar = ddpm.p_mean_variance(x0_pred, xi, ib)
    if i == 0:
        return mean
    return mean + torch.exp(0.5 * logvar) * draw(xi, "posterior", i)


def _corrector_steps(draw: NoiseFn, x0_model, ddpm: DDPM, xi: torch.Tensor,
                     ib: torch.Tensor, i: int, n_corrector: int,
                     delta: float) -> torch.Tensor:
    """`n_corrector` Langevin corrector steps."""
    dt = (ddpm.tmax - ddpm.tmin) / ddpm.num_steps
    for j in range(n_corrector):
        score = ddpm.score_from_x0(x0_model(xi, ib), ib)
        xi = (xi + 0.5 * dt * delta * score
              + math.sqrt(dt * delta) * draw(xi, "corrector", i, j))
    return xi


def _reverse_scan(xT: torch.Tensor, step_fn, num_steps: int) -> torch.Tensor:
    """Run `step_fn(xi, i)` over i = Ns-1 .. 0."""
    xi = xT
    for i in range(num_steps - 1, -1, -1):
        xi = step_fn(xi, i)
    return process_x0(xi)


def guidance_gradient(x0_model, likelihood: Likelihood,
                      condition: torch.Tensor, xi: torch.Tensor,
                      ib: torch.Tensor) -> torch.Tensor:
    """d/dxi of sum_b likelihood.loss(x0_model(xi, i), condition), through
    the eps model; equal to the per-sample gradient because inference
    couples no samples."""
    with torch.enable_grad():
        x = xi.detach().requires_grad_(True)
        total = likelihood.loss(x0_model(x, ib), condition).sum()
        (grad,) = torch.autograd.grad(total, x)
    return grad


# ---------------------------------------------------------------------------
# Prior sampling
# ---------------------------------------------------------------------------


def make_prior_sampler(eps_fn: EpsFn, ddpm: DDPM,
                       conditioning: Optional[Conditioning] = None,
                       likelihood: Optional[Likelihood] = None) -> Callable:
    """Unconditional ancestral sampling, `sample(xT, generator=None, *,
    noise=None) -> x0`. For an amortized model the "none" condition rides
    along as pad channels."""
    amortized = isinstance(conditioning, Amortized)
    if amortized and likelihood is None:
        raise ValueError("an amortized prior sampler needs the likelihood "
                         "(its none_like pad channels)")

    @torch.no_grad()
    def sample(xT: torch.Tensor, generator: torch.Generator | None = None,
               *, noise: NoiseFn | None = None) -> torch.Tensor:
        draw = noise or randn_noise(generator)
        dd = ddpm.to(xT.device)
        fn = (amortized_eps_fn(eps_fn, likelihood.none_like(xT)) if amortized
              else eps_fn)
        x0_model = make_x0_model(fn, dd)

        def step(xi, i):
            ib = _batched(i, xi)
            return _posterior_step(draw, dd, x0_model(xi, ib), xi, ib, i)

        return _reverse_scan(xT, step, dd.num_steps)

    return sample


# ---------------------------------------------------------------------------
# Conditional sampling (dispatch on the conditioning type)
# ---------------------------------------------------------------------------


def make_conditional_sampler(eps_fn: EpsFn, ddpm: DDPM,
                             conditioning: Conditioning,
                             likelihood: Likelihood) -> Callable:
    """`sample(xT, condition, generator=None, *, noise=None) -> x0`."""
    if isinstance(conditioning, Amortized):
        return _make_amortized_sampler(eps_fn, ddpm, conditioning, likelihood)
    if isinstance(conditioning, ReconstructionGuidance):
        return _make_guidance_sampler(eps_fn, ddpm, conditioning, likelihood)
    if isinstance(conditioning, Replacement):
        return _make_replacement_sampler(eps_fn, ddpm, conditioning,
                                         likelihood)
    raise NotImplementedError(type(conditioning))


def _make_amortized_sampler(eps_fn, ddpm, cond: Amortized, likelihood):
    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        dd = ddpm.to(xT.device)
        x0_model = make_x0_model(amortized_eps_fn(eps_fn, condition), dd)
        # the corrector runs unconditioned, on none_like pad channels, as in
        # the reference (sampling.py:113-121 with cond=None); only the
        # posterior step sees the condition
        x0_uncond = make_x0_model(
            amortized_eps_fn(eps_fn, likelihood.none_like(condition)), dd)

        def step(xi, i):
            ib = _batched(i, xi)
            xi = _posterior_step(draw, dd, x0_model(xi, ib), xi, ib, i)
            return _corrector_steps(draw, x0_uncond, dd, xi, ib, i,
                                    cond.n_corrector, cond.delta)

        return _reverse_scan(xT, step, dd.num_steps)

    return sample


def reuse_groups(steps, encoder_reuse: int) -> list:
    """`steps` (in the chain's order) in groups of `encoder_reuse`, each
    group sharing one encoder pass; a non-dividing K runs the remainder as
    a shorter first group at the high-noise end."""
    if encoder_reuse < 1:
        raise ValueError(f"encoder_reuse={encoder_reuse} must be >= 1")
    rem = len(steps) % encoder_reuse
    return ([steps[:rem]] if rem else []) + [
        steps[s:s + encoder_reuse]
        for s in range(rem, len(steps), encoder_reuse)]


def make_cached_amortized_sampler(encode_fn: Callable, decode_fn: Callable,
                                  ddpm: DDPM, cond: Amortized,
                                  likelihood: Likelihood,
                                  encoder_reuse: int = 2) -> Callable:
    """Amortized ancestral sampling with encoder-feature reuse
    (arXiv:2312.09608): `encode_fn(x_cat, i) -> cache` refreshes the UNet
    encoder cache on the first step of each group of `encoder_reuse` steps;
    posterior and corrector steps decode from it with the current timestep
    (`decode_fn(x_cat, i, cache) -> eps`). `encoder_reuse=1` with
    `n_corrector=0` is exactly `_make_amortized_sampler`.

    As in the JAX package, the corrector here decodes from the conditioned
    cache, where the plain sampler's corrector runs unconditioned."""
    del likelihood  # the cached corrector is conditioned
    groups = reuse_groups(range(ddpm.num_steps - 1, -1, -1), encoder_reuse)

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        dd = ddpm.to(xT.device)

        def cat(x):
            return torch.cat([x, condition], dim=-1)

        xi = xT
        for group in groups:
            cache = None
            for j, i in enumerate(group):
                ib = _batched(i, xi)
                if j == 0:
                    cache = encode_fn(cat(xi), ib)

                def x0_model(x, ib, cache=cache):
                    return process_x0(dd.predict_start_from_noise(
                        x, ib, decode_fn(cat(x), ib, cache)))

                xi = _posterior_step(draw, dd, x0_model(xi, ib), xi, ib, i)
                xi = _corrector_steps(draw, x0_model, dd, xi, ib, i,
                                      cond.n_corrector, cond.delta)
        return process_x0(xi)

    return sample


def _make_guidance_sampler(eps_fn, ddpm, cond: ReconstructionGuidance,
                           likelihood):
    start_step = int(ddpm.num_steps * cond.start_fraction)

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        dd = ddpm.to(xT.device)
        x0_model = make_x0_model(eps_fn, dd)

        def step(xi, i):
            ib = _batched(i, xi)
            if i >= start_step:
                # guidance inactive: no gradient, one model evaluation
                xi_next = _posterior_step(draw, dd, x0_model(xi, ib), xi, ib,
                                          i)
            else:
                x_grad = guidance_gradient(x0_model, likelihood, condition,
                                           xi, ib)
                alpha_i = dd.alphas[i]
                x_update = -(cond.gamma * alpha_i * (1.0 - alpha_i)) * x_grad
                if cond.update_rule == "before":
                    xi = xi + x_update
                xi_next = _posterior_step(draw, dd, x0_model(xi, ib), xi, ib,
                                          i)
                if cond.update_rule == "after":
                    xi_next = xi_next + x_update
            return _corrector_steps(draw, x0_model, dd, xi_next, ib, i,
                                    cond.n_corrector, cond.delta)

        return _reverse_scan(xT, step, dd.num_steps)

    return sample


def _make_replacement_sampler(eps_fn, ddpm, cond: Replacement, likelihood):
    if not isinstance(likelihood, Painting):
        raise NotImplementedError(
            "Replacement conditioning requires a Painting likelihood with a "
            "pad_value mask (reference sampling.py:225-232)")
    start_step = int(ddpm.num_steps * cond.start_fraction)

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        dd = ddpm.to(xT.device)
        x0_model = make_x0_model(eps_fn, dd)
        observed = likelihood.observed_mask(condition)

        def step(xi, i):
            ib = _batched(i, xi)
            if i < start_step:
                noised = condition
                if cond.noise:
                    noised, _ = dd.q_sample(
                        condition, ib, noise=draw(condition, "replace", i))
                xi = torch.where(observed, noised, xi)
            xi = _posterior_step(draw, dd, x0_model(xi, ib), xi, ib, i)
            return _corrector_steps(draw, x0_model, dd, xi, ib, i,
                                    cond.n_corrector, cond.delta)

        return _reverse_scan(xT, step, dd.num_steps)

    return sample


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------


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
    groups = reuse_groups(_ddim_per_step(ddpm, num_steps, eta),
                          encoder_reuse)

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
