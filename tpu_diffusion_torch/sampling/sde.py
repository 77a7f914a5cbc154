"""SDE samplers over the continuous VP-SDE: Euler-Maruyama reverse SDE,
probability-flow ODE and predictor-corrector, in PyTorch.

Counterpart of `tpu_diffusion/sampling/sde.py` (the reference's notebook
Euler-Maruyama loop, `notebooks/train_image_diffusion.py:69-92`, made first
class). The JAX package runs each as one `lax.scan`; here each is a Python
loop over `num_steps` steps, t from `sde.tmax` down to `sde.tmin`:

  * euler_maruyama: dx = [f(x,t) - g^2 score] dt + g dW, no noise on the
    last step. A step's NaNs are zeroed (`torch.nan_to_num`) so the chain
    runs on; `return_nan_flag=True` also returns a 0-d bool tensor, True
    when any step produced a non-finite value (read it once, after the
    chain: the loop itself never synchronises).
  * probability_flow: dx = [f - g^2/2 score] dt (deterministic).
  * predictor_corrector: the Euler-Maruyama predictor, then `n_corrector`
    Langevin steps whose size follows the signal-to-noise ratio `snr`
    (Song et al. 2021).

`score_fn(x, t)` takes t as a [B] tensor in [tmin, tmax]. Noise comes from
one source, `noise(like, kind, k, j)` -> standard normal noise of `like`'s
shape, where `kind` is "predictor" (step k) or "corrector" (Langevin
iterate j after step k); the default, `randn_noise(generator)`, draws with
`torch.randn` in call order, and a test passes a source that replays the
JAX key tree. The predictor draws no noise on the last step, where the JAX
package multiplies it by 0.

Given a `sampling/graph.py:GraphCache` (`graphs=`), each sampler runs as a
graphed chain: its step captured once as a CUDA graph and replayed on a
CUDA tensor (the same body in a Python loop on a CPU tensor), t, dt and
sqrt(dt) read from device tables at the chain's counter, the noise drawn
before each replay as the eager loop draws it, the NaN flag a device
buffer; bitwise equal to the eager loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_diffusion_torch.core.schedules import DDPM, VPSDE, bcast_right
from tpu_diffusion_torch.sampling.ancestral import NoiseFn, randn_noise
from tpu_diffusion_torch.sampling.graph import (GraphCache, row_at, rows_at,
                                                scan)

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _time_grid(sde: VPSDE, num_steps: int):
    """(t_k, dt_k, sqrt(dt_k)) for k < num_steps as host floats (fp32
    values, so the chain needs no device read): t from tmax to tmin."""
    ts = torch.linspace(sde.tmax, sde.tmin, num_steps + 1)
    dts = ts[:-1] - ts[1:]  # positive
    return ts.tolist(), dts.tolist(), torch.sqrt(dts).tolist()


def _graphed_chain(graphs: GraphCache, slot, score_fn: ScoreFn,
                   sde: VPSDE, xT: torch.Tensor, num_steps: int,
                   draw: NoiseFn, predictor: str, n_corrector: int = 0,
                   corrector_step=None):
    """The reverse chain through `graph.scan`; returns (x, nan flag).
    `predictor` is "em" (Euler-Maruyama, noise on every step but the last)
    or "flow" (the probability flow, no noise); `corrector_step(x, t, z)`
    runs after each step with its noise z."""
    grid = torch.linspace(sde.tmax, sde.tmin, num_steps + 1)
    dgrid = grid[:-1] - grid[1:]

    def make_step(buf):
        dev, dtype = xT.device, xT.dtype
        ts = grid[:-1].to(dev, dtype)
        ts_next = grid[1:].to(dev, dtype)
        dts = dgrid.to(dev)
        sqrt_dts = torch.sqrt(dgrid).to(dev)

        def step(scratch, x, k, j, noisy, noise):
            b = x.shape[0]
            t = rows_at(ts, k, b)
            dt = row_at(dts, k)
            noise = list(noise)
            if predictor == "flow":
                return x - dt * sde.probability_flow_drift(score_fn(x, t),
                                                           x, t)
            drift = sde.backward_drift(score_fn(x, t), x, t)
            x = x - dt * drift
            if noisy:
                g = bcast_right(sde.diffusion(t), x.ndim)
                x = x + g * row_at(sqrt_dts, k) * noise.pop(0)
            if corrector_step is not None:
                t_next = rows_at(ts_next, k, b)
                for z in noise:
                    x = corrector_step(x, t_next, z)
            buf["bad"].logical_or_(~torch.isfinite(x).all())
            return torch.nan_to_num(x)

        return step

    def draws_of(noisy):
        return ((("predictor", 0, "x"),) if noisy else ()) + tuple(
            ("corrector", j, "x") for j in range(n_corrector))

    bad = torch.zeros((), dtype=torch.bool, device=xT.device)
    return scan(graphs, (slot, predictor, num_steps, n_corrector, sde),
                score_fn, xT, [[k] for k in range(num_steps)], make_step,
                inputs={"bad": bad},
                sig_of=lambda k: predictor == "em" and k < num_steps - 1,
                draws_of=draws_of, draw=draw, outputs=("bad",))


def _reverse_chain(score_fn: ScoreFn, sde: VPSDE, xT: torch.Tensor,
                   num_steps: int, draw: NoiseFn, return_nan_flag: bool,
                   corrector=None):
    """The Euler-Maruyama predictor over the grid, each step followed by
    `corrector(x, t_next, k)` when given."""
    ts, dts, sqrt_dts = _time_grid(sde, num_steps)
    x = xT
    bad = torch.zeros((), dtype=torch.bool, device=xT.device)
    for k in range(num_steps):
        t = torch.full((x.shape[0],), ts[k], dtype=x.dtype, device=x.device)
        drift = sde.backward_drift(score_fn(x, t), x, t)
        x = x - dts[k] * drift
        if k < num_steps - 1:
            g = bcast_right(sde.diffusion(t), x.ndim)
            x = x + g * sqrt_dts[k] * draw(x, "predictor", k)
        if corrector is not None:
            x = corrector(x, torch.full_like(t, ts[k + 1]), k)
        bad = bad | ~torch.isfinite(x).all()
        x = torch.nan_to_num(x)
    return (x, bad) if return_nan_flag else x


def euler_maruyama(generator: Optional[torch.Generator], score_fn: ScoreFn,
                   sde: VPSDE, xT: torch.Tensor, num_steps: int = 1000,
                   return_nan_flag: bool = False, *,
                   noise: Optional[NoiseFn] = None,
                   graphs: Optional[GraphCache] = None):
    """Reverse-SDE Euler-Maruyama integration from xT at tmax to tmin; x0,
    or (x0, nan_flag) with `return_nan_flag`."""
    draw = noise or randn_noise(generator)
    if graphs is not None:
        x, bad = _graphed_chain(graphs, "euler_maruyama", score_fn, sde, xT,
                                num_steps, draw, "em")
        return (x, bad) if return_nan_flag else x
    return _reverse_chain(score_fn, sde, xT, num_steps, draw,
                          return_nan_flag)


def probability_flow(score_fn: ScoreFn, sde: VPSDE, xT: torch.Tensor,
                     num_steps: int = 100, *,
                     graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """The deterministic probability-flow ODE (sde_diffusion.py:80-84)."""
    if graphs is not None:
        return _graphed_chain(graphs, "probability_flow", score_fn, sde, xT,
                              num_steps, None, "flow")[0]
    ts, dts, _ = _time_grid(sde, num_steps)
    x = xT
    for k in range(num_steps):
        t = torch.full((x.shape[0],), ts[k], dtype=x.dtype, device=x.device)
        x = x - dts[k] * sde.probability_flow_drift(score_fn(x, t), x, t)
    return x


def _langevin_step(score_fn: ScoreFn, snr: float, x: torch.Tensor,
                   t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    grad = score_fn(x, t)
    gn = torch.sqrt(torch.mean(grad**2) + 1e-12)
    eps = 2.0 * (snr / gn) ** 2  # E||z|| / sqrt(d) = 1 for N(0, I)
    return x + eps * grad + torch.sqrt(2.0 * eps) * z


def predictor_corrector(generator: Optional[torch.Generator],
                        score_fn: ScoreFn, sde: VPSDE, xT: torch.Tensor,
                        num_steps: int = 1000, n_corrector: int = 1,
                        snr: float = 0.16, return_nan_flag: bool = False,
                        *, noise: Optional[NoiseFn] = None,
                        graphs: Optional[GraphCache] = None):
    """Euler-Maruyama predictor + Langevin corrector (Song et al. 2021 PC
    sampler). The corrector's step is 2 (snr / |score|_rms)^2, |score|_rms
    over the whole batch. NaN handling as in `euler_maruyama`."""
    draw = noise or randn_noise(generator)
    if graphs is not None:
        x, bad = _graphed_chain(
            graphs, ("predictor_corrector", snr), score_fn, sde, xT,
            num_steps, draw, "em", n_corrector,
            lambda x, t, z: _langevin_step(score_fn, snr, x, t, z))
        return (x, bad) if return_nan_flag else x

    def corrector(x, t, k):
        for j in range(n_corrector):
            x = _langevin_step(score_fn, snr, x, t,
                               draw(x, "corrector", k, j))
        return x

    return _reverse_chain(score_fn, sde, xT, num_steps, draw,
                          return_nan_flag, corrector)


def reverse_sde_sampler_from_eps(eps_fn, ddpm: DDPM) -> ScoreFn:
    """A discrete eps model as a continuous score for the SDE samplers:
    score(x, t) = -eps(x, i) / sigma_i with i = round(t * Ns), clipped to
    [0, Ns) (round, not truncate: a float32 0.8999999 is step 900)."""
    def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        i = torch.clamp(torch.round(t * ddpm.num_steps).long(), 0,
                        ddpm.num_steps - 1)
        return ddpm.score_from_noise(eps_fn(x, i), i)
    return score_fn
