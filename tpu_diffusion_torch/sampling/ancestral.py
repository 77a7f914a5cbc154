"""Ancestral DDPM samplers (prior and three conditioning modes) and DDIM.

Counterpart of `tpu_diffusion/sampling/ancestral.py`. The JAX package runs
each chain as one jitted `lax.scan`. Here a sampler factory given a
`sampling/graph.py:GraphCache` (`graphs=`) returns the graphed chain: its
step (or K-step group) captured once as a CUDA graph and replayed, with the
per-step values in device tables, on a CUDA tensor, and the same bodies in a
Python loop on a CPU tensor; without one it returns the eager Python loop
over the steps. The two are bitwise equal from the same generator. The
guidance sampler's guided step differentiates through the model inside its
captured body. `eps_fn(x, i)` predicts noise for discrete steps `i` ([B]
integers); an amortized model also receives the condition as extra
channels.

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
from tpu_diffusion_torch.sampling.graph import (GraphCache, row_at, rows_at,
                                                scan)
from tpu_diffusion_torch.utils import spans

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


def classifier_free_eps_fn(eps_fn: EpsFn, scale: float) -> EpsFn:
    """Classifier-free guidance (arXiv:2207.12598) in one model call:
    `eps_fn(x2, i2)` predicts the noise of 2B rows, the first B under the
    condition and the last B without it (the model reads which is which
    from its own inputs, e.g. a [cond; uncond] context it holds), and the
    result is eps_u + scale (eps_c - eps_u) in fp32."""
    def fn(xi: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        eps = eps_fn(torch.cat([xi, xi]), torch.cat([i, i])).float()
        cond, uncond = eps.chunk(2)
        return uncond + scale * (cond - uncond)
    return fn


def _batched(i: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((like.shape[0],), i, dtype=torch.long,
                      device=like.device)


def _posterior_update(ddpm: DDPM, x0_pred: torch.Tensor, xi: torch.Tensor,
                      ib: torch.Tensor, noise: torch.Tensor | None):
    """Posterior mean + sigma * noise (the mean alone without noise)."""
    mean, _, logvar = ddpm.p_mean_variance(x0_pred, xi, ib)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise


def _posterior_step(draw: NoiseFn, ddpm: DDPM, x0_pred: torch.Tensor,
                    xi: torch.Tensor, ib: torch.Tensor, i: int):
    """One ancestral step: posterior mean + sigma * noise (none at i == 0)."""
    return _posterior_update(ddpm, x0_pred, xi, ib,
                             draw(xi, "posterior", i) if i else None)


def _corrector_update(x0_model, ddpm: DDPM, xi: torch.Tensor,
                      ib: torch.Tensor, noise: torch.Tensor,
                      delta: float) -> torch.Tensor:
    """One Langevin corrector step."""
    dt = (ddpm.tmax - ddpm.tmin) / ddpm.num_steps
    score = ddpm.score_from_x0(x0_model(xi, ib), ib)
    return xi + 0.5 * dt * delta * score + math.sqrt(dt * delta) * noise


def _corrector_steps(draw: NoiseFn, x0_model, ddpm: DDPM, xi: torch.Tensor,
                     ib: torch.Tensor, i: int, n_corrector: int,
                     delta: float) -> torch.Tensor:
    """`n_corrector` Langevin corrector steps."""
    for j in range(n_corrector):
        xi = _corrector_update(x0_model, ddpm, xi, ib,
                               draw(xi, "corrector", i, j), delta)
    return xi


def _ancestral_draws(n_corrector: int, replace_noise: bool = False):
    """draws_of for `graph.scan`: a step's signature is (replace, noisy,
    guided); the eager chain draws the replacement's noise, the
    posterior's (not at step 0) and the correctors', in that order (the
    guidance gradient draws none)."""
    def draws_of(sig):
        replace, noisy, _ = sig
        return ((("replace", 0, "cond"),) if replace and replace_noise
                else ()) + ((("posterior", 0, "x"),) if noisy else ()) + tuple(
            ("corrector", j, "x") for j in range(n_corrector))
    return draws_of


def _graphed_ancestral(graphs: GraphCache, slot, fn, ddpm: DDPM,
                       xT: torch.Tensor, groups, make_models, draw: NoiseFn,
                       inputs=None, n_corrector: int = 0, delta: float = 0.0,
                       replace_from: int = -1, replace_noise: bool = False,
                       guide_from: int = -1, guide=None,
                       update_rule: str = "before"):
    """An ancestral chain through `graph.scan`, steps `groups` (lists of
    steps i, descending). `make_models(buf, dd, scratch, xi, ib, j)`
    returns the step's (posterior x0 model, corrector x0 model); a step with
    i < replace_from first replaces the observed pixels (the mask buffer
    "observed") by the condition, noised to step i with `replace_noise`; a
    step with i < guide_from adds `guide(buf, dd, x0_model, xi, ib)` (the
    guidance update, which differentiates through the model) to the iterate
    before the posterior step or to its result, by `update_rule`."""
    def make_step(buf):
        dd = ddpm.to(xT.device)
        steps = torch.arange(dd.num_steps - 1, -1, -1, device=xT.device)

        def step(scratch, xi, t, j, sig, noise):
            ib = rows_at(steps, t, xi.shape[0])
            replace, noisy, guided = sig
            noise = list(noise)
            if replace:
                noised = buf["cond"]
                if replace_noise:
                    noised = dd.q_sample_with_noise(buf["cond"],
                                                    noise.pop(0), ib)
                xi = torch.where(buf["observed"], noised, xi)
            x0_post, x0_corr = make_models(buf, dd, scratch, xi, ib, j)
            if guided:
                x_update = guide(buf, dd, x0_post, xi, ib)
                if update_rule == "before":
                    xi = xi + x_update
            xi = _posterior_update(dd, x0_post(xi, ib), xi, ib,
                                   noise.pop(0) if noisy else None)
            if guided and update_rule == "after":
                xi = xi + x_update
            for z in noise:
                xi = _corrector_update(x0_corr, dd, xi, ib, z, delta)
            return xi

        return step

    out = scan(graphs, slot, fn, xT, groups, make_step, inputs=inputs,
               sig_of=lambda i: (i < replace_from, i != 0, i < guide_from),
               draws_of=_ancestral_draws(n_corrector, replace_noise),
               draw=draw)
    return process_x0(out)


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


def _one_step_groups(ddpm: DDPM) -> list:
    return [[i] for i in range(ddpm.num_steps - 1, -1, -1)]


def make_prior_sampler(eps_fn: EpsFn, ddpm: DDPM,
                       conditioning: Optional[Conditioning] = None,
                       likelihood: Optional[Likelihood] = None,
                       graphs: GraphCache | None = None) -> Callable:
    """Unconditional ancestral sampling, `sample(xT, generator=None, *,
    noise=None) -> x0`. For an amortized model the "none" condition rides
    along as pad channels. With `graphs`, the graphed chain."""
    amortized = isinstance(conditioning, Amortized)
    if amortized and likelihood is None:
        raise ValueError("an amortized prior sampler needs the likelihood "
                         "(its none_like pad channels)")
    tag = object()

    @torch.no_grad()
    def sample(xT: torch.Tensor, generator: torch.Generator | None = None,
               *, noise: NoiseFn | None = None) -> torch.Tensor:
        draw = noise or randn_noise(generator)
        if graphs is not None:
            def models(buf, dd, scratch, xi, ib, j):
                fn = (amortized_eps_fn(eps_fn, buf["none"]) if amortized
                      else eps_fn)
                return make_x0_model(fn, dd), None

            return _graphed_ancestral(
                graphs, (tag, "prior"), eps_fn, ddpm, xT,
                _one_step_groups(ddpm), models, draw,
                inputs=({"none": likelihood.none_like(xT)} if amortized
                        else None))
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
                             likelihood: Likelihood,
                             graphs: GraphCache | None = None) -> Callable:
    """`sample(xT, condition, generator=None, *, noise=None) -> x0`. With
    `graphs`, the graphed chain."""
    if isinstance(conditioning, Amortized):
        return _make_amortized_sampler(eps_fn, ddpm, conditioning, likelihood,
                                       graphs)
    if isinstance(conditioning, ReconstructionGuidance):
        return _make_guidance_sampler(eps_fn, ddpm, conditioning, likelihood,
                                      graphs)
    if isinstance(conditioning, Replacement):
        return _make_replacement_sampler(eps_fn, ddpm, conditioning,
                                         likelihood, graphs)
    raise NotImplementedError(type(conditioning))


def _make_amortized_sampler(eps_fn, ddpm, cond: Amortized, likelihood,
                            graphs=None):
    tag = object()

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        if graphs is not None:
            def models(buf, dd, scratch, xi, ib, j):
                return (make_x0_model(amortized_eps_fn(eps_fn, buf["cond"]),
                                      dd),
                        make_x0_model(amortized_eps_fn(eps_fn, buf["none"]),
                                      dd))

            return _graphed_ancestral(
                graphs, (tag, "amortized"), eps_fn, ddpm, xT,
                _one_step_groups(ddpm), models, draw,
                inputs={"cond": condition,
                        "none": likelihood.none_like(condition)},
                n_corrector=cond.n_corrector, delta=cond.delta)
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
                                  encoder_reuse: int = 2,
                                  graphs: GraphCache | None = None
                                  ) -> Callable:
    """Amortized ancestral sampling with encoder-feature reuse
    (arXiv:2312.09608): `encode_fn(x_cat, i) -> cache` refreshes the UNet
    encoder cache on the first step of each group of `encoder_reuse` steps;
    posterior and corrector steps decode from it with the current timestep
    (`decode_fn(x_cat, i, cache) -> eps`). `encoder_reuse=1` with
    `n_corrector=0` is exactly `_make_amortized_sampler`.

    As in the JAX package, the corrector here decodes from the conditioned
    cache, where the plain sampler's corrector runs unconditioned. With
    `graphs`, the graphed chain: one body per K-step group, its encoder's
    end marked "encode" (`utils/spans.py:mark`)."""
    del likelihood  # the cached corrector is conditioned
    groups = reuse_groups(range(ddpm.num_steps - 1, -1, -1), encoder_reuse)
    tag = object()

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        if graphs is not None:
            def models(buf, dd, scratch, xi, ib, j):
                def cat(x):
                    return torch.cat([x, buf["cond"]], dim=-1)
                if j == 0:
                    scratch["cache"] = encode_fn(cat(xi), ib)
                    spans.mark("encode")
                cache = scratch["cache"]

                def x0_model(x, ib):
                    return process_x0(dd.predict_start_from_noise(
                        x, ib, decode_fn(cat(x), ib, cache)))
                return x0_model, x0_model

            return _graphed_ancestral(
                graphs, (tag, "cached_amortized"), encode_fn, ddpm, xT,
                [list(g) for g in groups], models, draw,
                inputs={"cond": condition}, n_corrector=cond.n_corrector,
                delta=cond.delta)
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


def _guidance_update(cond: ReconstructionGuidance, x_grad: torch.Tensor,
                     alpha_i: torch.Tensor) -> torch.Tensor:
    return -(cond.gamma * alpha_i * (1.0 - alpha_i)) * x_grad


def _make_guidance_sampler(eps_fn, ddpm, cond: ReconstructionGuidance,
                           likelihood, graphs=None):
    """Steps i >= start_step plain (one model evaluation), the others
    guided: the gradient of the likelihood loss of x0(xi) through the
    model, scaled by gamma * alpha_i * (1 - alpha_i), added before or after
    the posterior step. With `graphs`, the graphed chain: one body for the
    plain steps and one for the guided ones (and each for the noise-free
    step 0), the guided body differentiating inside its capture."""
    start_step = int(ddpm.num_steps * cond.start_fraction)
    tag = object()

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        if graphs is not None:
            def models(buf, dd, scratch, xi, ib, j):
                x0_model = make_x0_model(eps_fn, dd)
                return x0_model, x0_model

            def guide(buf, dd, x0_model, xi, ib):
                x_grad = guidance_gradient(x0_model, likelihood, buf["cond"],
                                           xi, ib)
                # alphas[i] read at the step index on the device
                return _guidance_update(cond, x_grad,
                                        row_at(dd.alphas, ib[0]))

            return _graphed_ancestral(
                graphs, (tag, "guidance"), eps_fn, ddpm, xT,
                _one_step_groups(ddpm), models, draw,
                inputs={"cond": condition}, n_corrector=cond.n_corrector,
                delta=cond.delta, guide_from=start_step, guide=guide,
                update_rule=cond.update_rule)
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
                x_update = _guidance_update(cond, x_grad, dd.alphas[i])
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


def _make_replacement_sampler(eps_fn, ddpm, cond: Replacement, likelihood,
                              graphs=None):
    if not isinstance(likelihood, Painting):
        raise NotImplementedError(
            "Replacement conditioning requires a Painting likelihood with a "
            "pad_value mask (reference sampling.py:225-232)")
    start_step = int(ddpm.num_steps * cond.start_fraction)
    tag = object()

    @torch.no_grad()
    def sample(xT, condition, generator=None, *, noise=None):
        draw = noise or randn_noise(generator)
        if graphs is not None:
            def models(buf, dd, scratch, xi, ib, j):
                x0_model = make_x0_model(eps_fn, dd)
                return x0_model, x0_model

            return _graphed_ancestral(
                graphs, (tag, "replacement"), eps_fn, ddpm, xT,
                _one_step_groups(ddpm), models, draw,
                inputs={"cond": condition,
                        "observed": likelihood.observed_mask(condition)},
                n_corrector=cond.n_corrector, delta=cond.delta,
                replace_from=start_step, replace_noise=cond.noise)
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


def _ddim_step(xi: torch.Tensor, eps: torch.Tensor, c,
               noise: torch.Tensor | None, clip: bool = True
               ) -> torch.Tensor:
    """One DDIM update from a coefficient row `c` (host floats, or the
    graphed chain's 0-d device tensors: the same fp32 values); `clip`
    clamps the x0 prediction into the data range."""
    _, cx0, cdir, sab, sig, sr, srm1 = (c[k] for k in range(7))
    x0 = sr * xi - srm1 * eps
    if clip:
        x0 = process_x0(x0)
    xi_next = cx0 * x0 + cdir * (xi - sab * x0)
    if noise is not None:
        xi_next = xi_next + sig * noise
    return xi_next


def _ddim_update(xi: torch.Tensor, eps: torch.Tensor, row: np.ndarray,
                 eta: float, draw: NoiseFn, k: int, clip: bool = True):
    """DDIM update `k` of the chain from its coefficient row."""
    noise = draw(xi, "eta", k) if eta != 0.0 else None
    c = [float(v) for v in row]
    if clip:
        return _ddim_step(xi, eps, c, noise)
    return _ddim_step(xi, eps, c, noise, clip=False)


def _step_index(xi: torch.Tensor, row: np.ndarray) -> torch.Tensor:
    return torch.full((xi.shape[0],), int(row[0]), dtype=torch.int32,
                      device=xi.device)


def _graphed_ddim(graphs: GraphCache, slot, fn, per_step: np.ndarray,
                  eta: float, groups, xT: torch.Tensor, draw: NoiseFn,
                  eps_fn=None, encode_fn=None,
                  decode_fn=None, clip: bool = True) -> torch.Tensor:
    """The DDIM chain through `graph.scan`: the coefficient rows and step
    indices in device tables read at the counter, one body per group
    length; eta > 0 draws each step's noise before the replay, as the
    eager chain draws it. A group's body marks the end of its encoder
    pass ("encode", `utils/spans.py:mark`). `clip` clamps each x0
    prediction and the result into the data range."""
    def make_step(buf):
        rows = torch.from_numpy(np.ascontiguousarray(per_step)).to(xT.device)
        steps = rows[:, 0].to(torch.int32)

        def step(scratch, xi, t, j, sig, noise):
            ib = rows_at(steps, t, xi.shape[0])
            if encode_fn is None:
                eps = eps_fn(xi, ib)
            else:
                if j == 0:
                    scratch["cache"] = encode_fn(xi, ib)
                    spans.mark("encode")
                eps = decode_fn(xi, ib, scratch["cache"])
            z = noise[0] if noise else None
            if clip:
                return _ddim_step(xi, eps, row_at(rows, t), z)
            return _ddim_step(xi, eps, row_at(rows, t), z, clip=False)

        return step

    out = scan(graphs, slot, fn, xT, groups, make_step,
               draws_of=lambda sig: (("eta", 0, "x"),) if eta != 0.0 else (),
               draw=draw)
    return process_x0(out) if clip else out


def make_ddim_sampler(eps_fn: EpsFn, ddpm: DDPM, num_steps: int = 100,
                      eta: float = 0.0,
                      graphs: GraphCache | None = None,
                      clip: bool = True) -> Callable:
    """Deterministic (eta=0) or stochastic DDIM over a strided step grid.

    Returns `sample(xT, generator=None, *, noise=None) -> x0`; the eta>0
    noise of update k is `noise(xi, "eta", k)`, by default `torch.randn` on
    `generator` (on xT's device). With `graphs`, the graphed chain (one
    body: a step). `clip` clamps every x0 prediction and the result into
    [-1, 1] (images); a latent-space model takes `clip=False` (Stable
    Diffusion's `clip_sample` false).
    """
    per_step = _ddim_per_step(ddpm, num_steps, eta)
    tag = object()

    @torch.no_grad()
    def sample(xT: torch.Tensor, generator: torch.Generator | None = None,
               *, noise: NoiseFn | None = None) -> torch.Tensor:
        draw = noise or randn_noise(generator)
        if graphs is not None:
            return _graphed_ddim(graphs, (tag, "ddim"), eps_fn, per_step,
                                 eta, [[k] for k in range(num_steps)], xT,
                                 draw, eps_fn=eps_fn, clip=clip)
        xi = xT
        for k, row in enumerate(per_step):
            eps = eps_fn(xi, _step_index(xi, row))
            xi = _ddim_update(xi, eps, row, eta, draw, k, clip)
        return process_x0(xi) if clip else xi

    return sample


def make_cached_ddim_sampler(encode_fn: Callable, decode_fn: Callable,
                             ddpm: DDPM, num_steps: int = 100,
                             eta: float = 0.0,
                             encoder_reuse: int = 2,
                             graphs: GraphCache | None = None) -> Callable:
    """DDIM with encoder-feature reuse across adjacent steps ("Faster
    Diffusion", arXiv:2312.09608).

    `encode_fn(x, i) -> cache` refreshes the `(bottleneck, skips)` cache on
    the first step of each group of `encoder_reuse` steps;
    `decode_fn(x, i, cache) -> eps` runs middle and decoder on every step.
    A non-dividing `encoder_reuse` runs the remainder as a shorter first
    group at the high-noise end. `encoder_reuse=1` is exactly the plain
    DDIM sampler. With `graphs`, the graphed chain: one body per K-step
    group (and one for a shorter first group).
    """
    per_step = _ddim_per_step(ddpm, num_steps, eta)
    groups = reuse_groups(list(range(num_steps)), encoder_reuse)
    tag = object()

    @torch.no_grad()
    def sample(xT: torch.Tensor, generator: torch.Generator | None = None,
               *, noise: NoiseFn | None = None) -> torch.Tensor:
        draw = noise or randn_noise(generator)
        if graphs is not None:
            return _graphed_ddim(graphs, (tag, "cached_ddim"), encode_fn,
                                 per_step, eta, groups, xT, draw,
                                 encode_fn=encode_fn, decode_fn=decode_fn)
        xi = xT
        for group in groups:
            cache = None
            for j, k in enumerate(group):
                ib = _step_index(xi, per_step[k])
                if j == 0:
                    cache = encode_fn(xi, ib)
                eps = decode_fn(xi, ib, cache)
                xi = _ddim_update(xi, eps, per_step[k], eta, draw, k)
        return process_x0(xi)

    return sample
