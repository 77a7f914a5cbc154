"""The eps-model adapter of the DDPM objectives, in PyTorch.

Counterpart of `tpu_diffusion/losses/ddpm.py:make_eps_model` and of the eps
half of `get_loss_function`: the network is called as `net(x, t)` with
continuous t, the samplers work on discrete steps i, and the adapter maps
i -> t = i / Ns. The training losses (`ddpm_loss`, `amortized_ddpm_loss`)
come with the training slice (ROADMAP A5).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpu_diffusion_torch.conditioning.guidance import Conditioning
from tpu_diffusion_torch.conditioning.likelihoods import Likelihood
from tpu_diffusion_torch.core.schedules import DDPM

Network = Callable[..., torch.Tensor]  # net(x, t[, ...]) -> eps


def make_eps_model(net: Network, ddpm: DDPM) -> Callable:
    """Adapter: discrete step i -> continuous t = i / Ns."""
    def eps_model(xi: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return net(xi, i.float() / ddpm.num_steps)
    return eps_model


def get_loss_function(net: Network, ddpm: DDPM, conditioning: Conditioning,
                      likelihood: Optional[Likelihood] = None
                      ) -> Tuple[Callable, Callable]:
    """(loss_fn, eps_model) as in the JAX package. The eps model is the same
    for every conditioning; `loss_fn` raises until the training slice ports
    the losses."""
    del conditioning, likelihood  # they select the training loss only

    def loss_fn(*args, **kwargs):
        raise NotImplementedError(
            "the DDPM training losses are not ported yet (ROADMAP A5, the "
            "training slice)")

    return loss_fn, make_eps_model(net, ddpm)
