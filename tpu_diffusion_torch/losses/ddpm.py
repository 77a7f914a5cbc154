"""DDPM training objectives (generic and amortized condition-dropout) and the
eps-model adapter, in PyTorch.

Counterpart of `tpu_diffusion/losses/ddpm.py`. The network is called as
`net(x, t)` with continuous t, the samplers work on discrete steps i, and
the adapter maps i -> t = i / Ns. Every draw comes from an explicit
`torch.Generator` on x's device; each loss also takes its draws as keyword
arguments (`i`, `noise`, `condition`, `use_cond`), so a test can hand both
packages the same ones. The amortized loss draws condition-vs-none once per
batch, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpu_diffusion_torch.conditioning.guidance import Amortized, Conditioning
from tpu_diffusion_torch.conditioning.likelihoods import Likelihood
from tpu_diffusion_torch.core.schedules import DDPM

Network = Callable[..., torch.Tensor]  # net(x, t[, ...]) -> eps


def make_eps_model(net: Network, ddpm: DDPM) -> Callable:
    """Adapter: discrete step i -> continuous t = i / Ns."""
    def eps_model(xi: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return net(xi, i.float() / ddpm.num_steps)
    return eps_model


def _draw_steps(generator, ddpm: DDPM, x: torch.Tensor) -> torch.Tensor:
    return torch.randint(0, ddpm.num_steps, (x.shape[0],),
                         generator=generator, device=x.device)


def ddpm_loss(generator: Optional[torch.Generator], net: Network, ddpm: DDPM,
              x: torch.Tensor, *, i: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain eps-matching MSE; i is drawn in [0, num_steps)."""
    if i is None:
        i = _draw_steps(generator, ddpm, x)
    xi, eps = ddpm.q_sample(x, i, noise=noise, generator=generator)
    eps_hat = make_eps_model(net, ddpm)(xi, i)
    return torch.mean((eps_hat.float() - eps) ** 2)


def amortized_ddpm_loss(generator: Optional[torch.Generator], net: Network,
                        ddpm: DDPM, conditioning: Amortized,
                        likelihood: Likelihood, x: torch.Tensor, *,
                        i: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        condition: Optional[torch.Tensor] = None,
                        use_cond: Optional[bool] = None) -> torch.Tensor:
    """Condition-dropout amortized loss: with probability p_cond (one draw
    per batch) a likelihood draw is concatenated on the channel axis, else
    the pad "none" condition."""
    if condition is None:
        condition = likelihood.sample(generator, x)
    if use_cond is None:
        use_cond = torch.rand((), generator=generator,
                              device=x.device) < conditioning.p_cond
    condition = torch.where(torch.as_tensor(use_cond, device=x.device),
                            condition, likelihood.none_like(x))
    if i is None:
        i = _draw_steps(generator, ddpm, x)
    xi, eps = ddpm.q_sample(x, i, noise=noise, generator=generator)
    eps_hat = make_eps_model(net, ddpm)(torch.cat([xi, condition], dim=-1), i)
    return torch.mean((eps_hat.float() - eps) ** 2)


def get_loss_function(net: Network, ddpm: DDPM, conditioning: Conditioning,
                      likelihood: Optional[Likelihood] = None
                      ) -> Tuple[Callable, Callable]:
    """(loss_fn(generator, x, **draws) -> scalar, eps_model(x, i)): the
    JAX package's dispatch on the conditioning type."""
    if isinstance(conditioning, Amortized):
        if likelihood is None:
            raise ValueError("amortized conditioning needs a likelihood")

        def loss_fn(generator, x, **draws):
            return amortized_ddpm_loss(generator, net, ddpm, conditioning,
                                       likelihood, x, **draws)
    else:
        def loss_fn(generator, x, **draws):
            return ddpm_loss(generator, net, ddpm, x, **draws)
    return loss_fn, make_eps_model(net, ddpm)


def weighted_mask_loss(vt: torch.Tensor, ut: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Pixel-weighted CFM loss (e.g. 10x weight inside the masked patch)."""
    return torch.mean(weight * (vt - ut) ** 2)
