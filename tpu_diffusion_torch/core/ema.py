"""Exponential moving averages of parameters, in PyTorch.

Counterpart of `tpu_diffusion/core/ema.py`: the EMA parameters and the
update counter, updated in place (the JAX package returns a new state).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


class EMAState:
    """EMA parameters (fp32 copies, by parameter name) and the counter."""

    def __init__(self, params: Mapping[str, torch.Tensor], count: int = 0):
        self.params: Dict[str, torch.Tensor] = {
            k: v.detach().clone() for k, v in params.items()}
        self.count = count

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor]) -> "EMAState":
        return cls(params)


@torch.no_grad()
def ema_update(state: EMAState, new_params: Mapping[str, torch.Tensor],
               decay: float, update_every: int = 1, update_after: int = 0,
               warmup: bool = False) -> EMAState:
    """ema <- decay * ema + (1 - decay) * params, gated on the counter.

    The counter advances on every call. Up to and including `update_after`
    calls the parameters are copied through; after that the blend happens
    on every `update_every`-th call. `warmup=True` ramps the effective
    decay as min(decay, (1 + n) / (10 + n)), so short runs track the live
    parameters instead of the initialisation.
    """
    state.count += 1
    n = state.count
    if warmup:
        decay = min(decay, (1.0 + n) / (10.0 + n))
    if n <= update_after:
        for k, e in state.params.items():
            e.copy_(new_params[k])
    elif n % update_every == 0:
        names = list(state.params)
        # e <- decay * e + (1 - decay) * p, as e += (1 - decay) * (p - e)
        # would round differently from the JAX package's blend
        ema = [state.params[k] for k in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [new_params[k].detach() for k in names],
                            alpha=1.0 - decay)
    return state
