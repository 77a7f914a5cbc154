"""Low-level building blocks of the diffusion UNet, in PyTorch.

Counterpart of `tpu_diffusion/models/nn.py`. Inside the model, images are
logical NCHW tensors in `torch.channels_last` memory, so `x.permute(0, 2, 3,
1)` is the NHWC tensor the JAX package works on, without a copy; the fused
norm kernel reads it in that layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.kernels.groupnorm import fused_groupnorm_silu

NORM_IMPLS = ("plain", "fused")


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embeddings [B, dim] in [cos, sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def num_groups_for(channels: int, num_groups: int = 32) -> int:
    """The largest group count <= num_groups that divides the channels."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics and eps 1e-5.

    The normalisation runs in fp32 and the result is cast once: to the
    input's type for `dtype=None`, to `dtype` otherwise (the bench's
    `norm_dtype=bf16`), as flax's GroupNorm does with fp32 statistics.
    """

    def __init__(self, channels: int, dtype: torch.dtype | None = None,
                 num_groups: int = 32, eps: float = 1e-5, device=None):
        super().__init__()
        self.groups = num_groups_for(channels, num_groups)
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias,
                         self.eps)
        return channels_last(y.to(self.dtype or x.dtype))


class FusedNormAct(nn.Module):
    """GroupNorm(+FiLM)+activation as one kernel (`norm_impl="fused"`).

    Same parameters as GroupNorm32 (fp32 `weight`/`bias`). `film` is the
    [B, 2C] embedding whose halves are the scale and the shift. It is
    differentiable: on the card through the kernel's own backward
    (`kernels/groupnorm.py:_GroupNormAct`), on the CPU through the plain
    version. Unlike GroupNorm32 + FiLM + SiLU it rounds once, at the end.
    """

    def __init__(self, channels: int, act: str = "silu", num_groups: int = 32,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.groups = num_groups_for(channels, num_groups)
        self.act = act
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor,
                film: torch.Tensor | None = None) -> torch.Tensor:
        c = x.shape[1]
        scale = shift = None
        if film is not None:
            scale, shift = film[:, :c], film[:, c:]
        y = fused_groupnorm_silu(channels_last(x).permute(0, 2, 3, 1),
                                 self.weight, self.bias, scale, shift,
                                 self.groups, self.eps, self.act)
        return y.permute(0, 3, 1, 2)


class _CastParams:
    """Mixin of a layer whose parameters are fp32 and whose forward runs in
    `compute_dtype`: the JAX package's flax layers (`param_dtype` fp32,
    `dtype` the compute type). Where autograd needs the parameter (training)
    the cast is part of the graph, so the gradient and the optimizer's
    update are fp32. Elsewhere (sampling) the cast copy is kept until the
    parameter changes, so a forward pays no cast."""

    def _init_cast(self, dtype) -> None:
        self.compute_dtype = dtype or torch.float32
        self._cast_cache: dict = {}

    def cast(self, name: str) -> torch.Tensor | None:
        full = self.__dict__.get(name)
        if full is not None:  # gathered for this call (parallel/tp.py)
            return full.to(self.compute_dtype)
        p = self._parameters[name]
        if p is None or p.dtype is self.compute_dtype:
            return p
        if p.requires_grad and torch.is_grad_enabled():
            return p.to(self.compute_dtype)
        # an in-place update bumps the version, a move to another device
        # changes the address
        key = (p._version, p.data_ptr())
        hit = self._cast_cache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(self.compute_dtype))
            self._cast_cache[name] = hit
        return hit[1]


class CastConv2d(_CastParams, nn.Conv2d):
    def __init__(self, *args, dtype=None, **kw):
        super().__init__(*args, dtype=torch.float32, **kw)
        self._init_cast(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.cast("weight"), self.cast("bias"))


class CastLinear(_CastParams, nn.Linear):
    def __init__(self, *args, dtype=None, **kw):
        super().__init__(*args, dtype=torch.float32, **kw)
        self._init_cast(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.cast("weight"), self.cast("bias"))


class CastEmbedding(_CastParams, nn.Embedding):
    """A lookup table of fp32 rows returned in `compute_dtype` (flax's
    `nn.Embed` with `dtype`)."""

    def __init__(self, *args, dtype=None, **kw):
        super().__init__(*args, dtype=torch.float32, **kw)
        self._init_cast(dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return F.embedding(y, self.cast("weight"))


def dropout_keep(shape, p: float, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """The keep mask of `dropout`: True with probability 1 - p."""
    return torch.rand(shape, generator=generator, device=device) >= p


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None = None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator`
    (`torch.nn.functional.dropout` takes none), or `keep` where it was
    drawn before (`dropout_keep`): an entry is kept with probability 1 - p
    and scaled by 1 / (1 - p)."""
    if keep is None:
        keep = dropout_keep(x.shape, p, generator, x.device)
    return x * keep.to(x.dtype) / (1.0 - p)


def zero_init_conv(module: nn.Module) -> nn.Module:
    """Zero a conv's or linear's weight and bias (the reference's
    `zero_module`)."""
    nn.init.zeros_(module.weight)
    nn.init.zeros_(module.bias)
    return module


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return channels_last(F.interpolate(x, scale_factor=factor,
                                       mode="nearest"))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return channels_last(F.avg_pool2d(x, 2, 2))
