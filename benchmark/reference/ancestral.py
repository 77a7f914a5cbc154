"""The plain reference of the amortized DDPM ancestral chain with encoder
reuse, in fp32 PyTorch and float64 NumPy, on `reference/unet.py`'s UNet.

Written from "Denoising Diffusion Probabilistic Models" (arXiv:2006.11239,
the posterior q(x_{i-1} | x_i, x_0) with the clipped log variance),
encoder reuse from "Faster Diffusion" (arXiv:2312.09608: the encoder on
the first step of each group of K steps, a shorter group first where K
does not divide the steps, the decoder every step with that step's time)
and the reference project's amortized conditioning (the condition image
as extra input channels). The discretised VP-SDE schedule is
`reference/diffusion.py:vp_alphas_cumprod`'s; x0 is clipped to [-1, 1]
at every step and at the end.

The reference draws what the system draws, in its order: after x_T, one
standard normal tensor of the whole batch's shape per step i > 0 (none at
step 0), from the system's generator restored to its state at the
chain's start; it runs the batch's images `rows` on their slices of those
draws.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.diffusion import reuse_groups


def posterior_tables(num_steps: int) -> dict:
    """Per step i, float32: sqrt(1 / abar), sqrt(1 / abar - 1), the
    posterior mean's coefficients of x0 and x_i, and its clipped log
    variance, from beta_i = (0.1 + 19.9 t_i) / N on t_i = linspace(1e-5, 1,
    N) in float64."""
    ts = np.linspace(1e-5, 1.0, num_steps, dtype=np.float64)
    betas = (0.1 + 19.9 * ts) / num_steps
    abar = np.cumprod(1.0 - betas)
    prev = np.concatenate([[1.0], abar[:-1]])
    var = betas * (1.0 - prev) / (1.0 - abar)
    rows = dict(sr=np.sqrt(1.0 / abar), srm1=np.sqrt(1.0 / abar - 1.0),
                c0=betas * np.sqrt(prev) / (1.0 - abar),
                ci=(1.0 - prev) * np.sqrt(1.0 - betas) / (1.0 - abar),
                logvar=np.log(np.maximum(var, 1e-20)))
    return {k: v.astype(np.float32) for k, v in rows.items()}


@torch.no_grad()
def amortized_chain(model, x_T: torch.Tensor, cond: torch.Tensor,
                    gen: torch.Generator, num_steps: int, reuse: int,
                    rows=None) -> torch.Tensor:
    """x0 of the ancestral chain of the batch's images `rows` (a list of
    indices; None: all) from x_T (NHWC, the whole batch) under the
    condition `cond` (the whole batch), the model called on [x, cond] with
    t = i / num_steps; `gen` draws each step's noise for the whole batch."""
    tab = posterior_tables(num_steps)
    shape = tuple(x_T.shape)
    rows = list(range(shape[0])) if rows is None else list(rows)
    x, cond, n = x_T[rows].float(), cond[rows], len(rows)
    for group in reuse_groups(num_steps, reuse):
        cache = None
        for j, k in enumerate(group):
            i = num_steps - 1 - k
            t = torch.full((n,), i / num_steps, dtype=torch.float32,
                           device=x.device)
            xc = torch.cat([x, cond.float()], dim=-1)
            if j == 0:
                cache = model(xc, t, mode="encode")
            eps = model(xc, t, mode="decode", cache=cache)
            x0 = torch.clamp(float(tab["sr"][i]) * x
                             - float(tab["srm1"][i]) * eps, -1.0, 1.0)
            mean = float(tab["c0"][i]) * x0 + float(tab["ci"][i]) * x
            if i > 0:
                z = torch.randn(shape, generator=gen, device=x.device)[rows]
                x = mean + float(np.exp(0.5 * tab["logvar"][i])) * z
            else:
                x = mean
    return torch.clamp(x, -1.0, 1.0)
