"""Exponential moving averages of parameters, in PyTorch.

Counterpart of `tpu_diffusion/core/ema.py`: the EMA parameters and the
update counter, updated in place (the JAX package returns a new state).

An update is split in two, so that a captured training step
(`train/graph.py`) replays it: `ema_fill` advances the host counter and
writes the call's blend weights into two 0-d device buffers, and
`ema_blend` is one body `e <- d * e + (1 - d) * p` that reads them. The
counter's three branches are three values of d: 0 copies the parameters
through, 1 keeps the EMA, anything else blends.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch


class EMAState:
    """EMA parameters (fp32 copies, by parameter name), the counter, and
    the blend weights d and 1 - d of the last `ema_fill` (0-d fp32 tensors
    on the parameters' device)."""

    def __init__(self, params: Mapping[str, torch.Tensor], count: int = 0):
        self.params: Dict[str, torch.Tensor] = {
            k: v.detach().clone() for k, v in params.items()}
        self.count = count
        device = next(iter(self.params.values())).device
        self.decay = torch.zeros((), dtype=torch.float32, device=device)
        self.rest = torch.ones((), dtype=torch.float32, device=device)

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor]) -> "EMAState":
        return cls(params)


def ema_fill(state: EMAState, decay: float, update_every: int = 1,
             update_after: int = 0, warmup: bool = False) -> None:
    """Advance the counter and write this call's blend weights.

    Up to and including `update_after` calls the parameters are copied
    through (d = 0); after that the blend happens on every
    `update_every`-th call (d = decay), and the other calls keep the EMA
    (d = 1). `warmup=True` ramps the effective decay as min(decay, (1 + n)
    / (10 + n)), so short runs track the live parameters instead of the
    initialisation."""
    state.count += 1
    n = state.count
    if warmup:
        decay = min(decay, (1.0 + n) / (10.0 + n))
    if n <= update_after:
        decay = 0.0
    elif n % update_every:
        decay = 1.0
    state.decay.fill_(decay)
    state.rest.fill_(1.0 - decay)


@torch.no_grad()
def ema_blend(state: EMAState, new_params: Mapping[str, torch.Tensor],
              names: Optional[Sequence[str]] = None) -> None:
    """e <- d * e + (1 - d) * p with the weights of the last `ema_fill`,
    for every EMA entry or those of `names`.

    The product (1 - d) * p is added in one rounding, as the alpha= add of
    an eager blend (`_foreach_add_(e, p, alpha=1 - d)`) does, so for finite
    values d = 0 gives p, d = 1 gives e, and a decay gives the eager
    blend, bitwise (a zero may change its sign). The training step's
    optimizer blends its parameters' entries inside the fused update on the
    card (`kernels/adam.py`), with the same arithmetic."""
    names = list(state.params) if names is None else list(names)
    if not names:
        return
    ema = [state.params[k] for k in names]
    torch._foreach_mul_(ema, state.decay)
    torch._foreach_addcmul_(ema, [new_params[k].detach() for k in names],
                            [state.rest] * len(names))


def ema_update(state: EMAState, new_params: Mapping[str, torch.Tensor],
               decay: float, update_every: int = 1, update_after: int = 0,
               warmup: bool = False) -> EMAState:
    """ema <- decay * ema + (1 - decay) * params, gated on the counter:
    `ema_fill`, then `ema_blend`."""
    ema_fill(state, decay, update_every, update_after, warmup)
    ema_blend(state, new_params)
    return state
