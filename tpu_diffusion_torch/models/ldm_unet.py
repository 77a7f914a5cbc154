"""The latent-diffusion UNet of Stable Diffusion 2 (inpainting), in PyTorch.

No JAX counterpart: the JAX package runs pixel-space UNets only. This is
diffusers' `UNet2DConditionModel` as the SD2-inpainting configuration uses
it (`stabilityai/stable-diffusion-2-inpainting`, `unet/config.json`),
written from its layer equations:

  ResBlock(x, emb)       = skip(x) + conv2(SiLU(GN(conv1(SiLU(GN(x)))
                           + W_e SiLU(emb))))          (`models/unet.py`)
  SpatialTransformer(x)  = x + proj_out(blocks(proj_in(GN_eps1e-6(x))))
                           on the H*W tokens, each block
      h += attn1(LN(h));  h += attn2(LN(h), context);
      h += W2 (a * GELU(g)), (a, g) = split(W1 LN(h))   (GEGLU)
  Downsample             = 3x3 conv, stride 2, padded 1 on every side
  Upsample               = nearest x2, then 3x3 conv   (`models/unet.py`)

with q, k, v projections without bias, heads of 64 (`attention_head_dim` is
the head count in diffusers' SD2 configurations), linear projections in and
out of the transformer (`use_linear_projection`), and the timestep embedded
as the integer step in [cos, sin] order (`flip_sin_to_cos`, `freq_shift`
0). Inputs are NHWC latents (the noisy latent, the mask and the masked
image's latent concatenated on the channel axis), `t` the integer steps and
`context` the [B, 77, cross_attention_dim] text embedding; the output is the
NHWC noise prediction.

As `UNetModel`: NCHW in `channels_last` memory inside, fp32 parameters
cast to `dtype` at use, GroupNorm and LayerNorm statistics in fp32, on the
card the GroupNorms through `FusedNormAct` (the GroupNorm kernel), the
LayerNorms through `kernels/layernorm.py:layer_norm`, the self-attention
through the flash forward and the cross-attention through
`flash_cross_attention`; on the CPU the kernels' plain versions. GEGLU is
plain torch ops. Parameter names are diffusers' state-dict keys
(`down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight`, ...),
so a released checkpoint loads by name. Sampling only: the cross-attention
and LayerNorm kernels have no backward.

`attn_decisions` / `xattn_decisions` map each transformer block's name to
its self- and cross-attention's route, query and key lengths and heads, as
of its last call. Each transformer block marks its entry and exit
("transformer.in", "transformer.out", `utils/spans.py:mark`), so a captured
step's replay splits into transformer and other device time.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.kernels.attention import (flash_attention,
                                                   flash_cross_attention,
                                                   flash_fwd_route)
from tpu_diffusion_torch.kernels.layernorm import layer_norm
from tpu_diffusion_torch.models.nn import (CastConv2d, CastLinear,
                                           FusedNormAct, channels_last,
                                           timestep_embedding)
from tpu_diffusion_torch.models.unet import ResBlock, Upsample, resolve_device
from tpu_diffusion_torch.utils import spans

DOWN_TYPES = ("CrossAttnDownBlock2D", "DownBlock2D")
UP_TYPES = ("UpBlock2D", "CrossAttnUpBlock2D")
TRANSFORMER_EPS = 1e-6  # diffusers' Transformer2DModel GroupNorm
LAYER_NORM_EPS = 1e-5


class LDMResBlock(ResBlock):
    """`models/unet.py:ResBlock` on its additive path, its submodules under
    diffusers' names (`norm1`, `conv1`, `time_emb_proj`, `norm2`, `conv2`,
    `conv_shortcut`); the forward reads them by the port's names."""

    NAMES = {"in_norm": "norm1", "in_conv": "conv1",
             "emb_dense": "time_emb_proj", "out_norm": "norm2",
             "out_conv": "conv2", "skip": "conv_shortcut"}

    def __init__(self, cin: int, cout: int, emb_dim: int, dtype, device):
        super().__init__(cin, cout, emb_dim, use_scale_shift_norm=False,
                         dtype=dtype, norm_impl="fused", device=device)
        self._modules = type(self._modules)(
            (self.NAMES.get(k, k), m) for k, m in self._modules.items())

    def __getattr__(self, name: str):
        return super().__getattr__(self.NAMES.get(name, name))


class Downsample(nn.Module):
    """3x3 conv, stride 2, padded 1 on every side (not the JAX package's
    "SAME", which pads the bottom and right only)."""

    def __init__(self, ch: int, dtype, device):
        super().__init__()
        self.conv = CastConv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class LayerNorm32(nn.Module):
    """LayerNorm over the channels with fp32 statistics and parameters; the
    result in the input's type (`kernels/layernorm.py:layer_norm`)."""

    def __init__(self, channels: int, eps: float = LAYER_NORM_EPS,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head attention over [B, T, C] tokens with bias-free q, k, v
    projections: self-attention through the flash forward, or, with
    `context_dim`, cross-attention to a [B, S, context_dim] context through
    `flash_cross_attention`."""

    def __init__(self, channels: int, heads: int, context_dim: int | None,
                 dtype, device):
        super().__init__()
        self.heads = heads
        self.cross = context_dim is not None
        kv = context_dim if self.cross else channels
        dd = dict(bias=False, dtype=dtype, device=device)
        self.to_q = CastLinear(channels, channels, **dd)
        self.to_k = CastLinear(kv, channels, **dd)
        self.to_v = CastLinear(kv, channels, **dd)
        self.to_out = nn.ModuleList([CastLinear(channels, channels,
                                                dtype=dtype, device=device)])

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        b, s, c = y.shape
        return y.reshape(b, s, self.heads, c // self.heads).transpose(
            1, 2).reshape(b * self.heads, s, c // self.heads).contiguous()

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None
                ) -> torch.Tensor:
        b, t, c = x.shape
        kv = context if self.cross else x
        q, k, v = (self._split(f(y)) for f, y in ((self.to_q, x),
                                                   (self.to_k, kv),
                                                   (self.to_v, kv)))
        o = (flash_cross_attention(q, k, v) if self.cross
             else flash_attention(q, k, v))
        o = o.reshape(b, self.heads, t, c // self.heads).transpose(1, 2)
        return self.to_out[0](o.reshape(b, t, c))

    def decision(self, b: int, t: int, s: int, dtype) -> dict:
        """The route a call on b images, t queries and s keys takes, and
        its [bh, t, d] shape."""
        bh, d = b * self.heads, self.to_q.out_features // self.heads
        if not self.to_q.weight.is_cuda:
            route = "plain"
        else:
            route = ("xattn" if self.cross
                     else flash_fwd_route(bh, t, d, dtype))
        return {"route": route, "bh": bh, "tq": t, "tk": s,
                "heads": self.heads, "d": d}


class GEGLU(nn.Module):
    def __init__(self, cin: int, cout: int, dtype, device):
        super().__init__()
        self.proj = CastLinear(cin, 2 * cout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class FeedForward(nn.Module):
    """`net`: GEGLU (C -> 2 x 4C), nothing (diffusers' dropout slot), 4C ->
    C."""

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(channels, 4 * channels, dtype, device), nn.Identity(),
            CastLinear(4 * channels, channels, dtype=dtype, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int, dtype,
                 device):
        super().__init__()
        self.norm1 = LayerNorm32(channels, device=device)
        self.attn1 = Attention(channels, heads, None, dtype, device)
        self.norm2 = LayerNorm32(channels, device=device)
        self.attn2 = Attention(channels, heads, context_dim, dtype, device)
        self.norm3 = LayerNorm32(channels, device=device)
        self.ff = FeedForward(channels, dtype, device)

    def forward(self, h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h), context)
        return h + self.ff(self.norm3(h))


class SpatialTransformer(nn.Module):
    """diffusers' `Transformer2DModel` with linear projections: the image's
    H*W pixels as tokens, one `TransformerBlock`, a residual around it."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 num_groups: int, dtype, device):
        super().__init__()
        self.norm = FusedNormAct(channels, act="none", num_groups=num_groups,
                                 eps=TRANSFORMER_EPS, device=device)
        self.proj_in = CastLinear(channels, channels, dtype=dtype,
                                  device=device)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            channels, heads, context_dim, dtype, device)])
        self.proj_out = CastLinear(channels, channels, dtype=dtype,
                                   device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(
            b, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class UNetBlock(nn.Module):
    """A level of the UNet: `resnets`, and, where the block type has them,
    `attentions` (one transformer after each ResBlock) and `downsamplers`
    or `upsamplers`."""

    def __init__(self, resnets, attentions=None, downsamplers=None,
                 upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


class LDMUNet(nn.Module):
    """model(x [B, H, W, in_channels], t [B] integer steps, context
    [B, S, cross_attention_dim]) -> eps [B, H, W, out_channels], fp32."""

    def __init__(self, in_channels: int = 9, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2,
                 down_block_types: Sequence[str] = (
                     "CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
                 up_block_types: Sequence[str] = (
                     "UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
                 attention_head_dim: Sequence[int] = (5, 10, 20, 20),
                 cross_attention_dim: int = 1024, norm_num_groups: int = 32,
                 norm_eps: float = 1e-5, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if norm_num_groups != 32 or norm_eps != 1e-5:
            raise ValueError("the ResBlocks' norms are 32 groups at eps "
                             f"1e-5, got {norm_num_groups}, {norm_eps}")
        bad = ([t for t in down_block_types if t not in DOWN_TYPES]
               + [t for t in up_block_types if t not in UP_TYPES])
        if bad:
            raise ValueError(f"unsupported block types {bad}")
        device = resolve_device(device)
        self.dtype = dtype
        self.attn_decisions: dict = {}
        self.xattn_decisions: dict = {}
        chans = list(block_out_channels)
        heads = list(attention_head_dim)
        ch0, tdim, n = chans[0], 4 * chans[0], len(chans)
        dd = dict(dtype=dtype, device=device)

        def res(cin, cout):
            return LDMResBlock(cin, cout, tdim, dtype, device)

        def transformer(ch, h):
            return SpatialTransformer(ch, h, cross_attention_dim,
                                      norm_num_groups, dtype, device)

        self.conv_in = CastConv2d(in_channels, ch0, 3, padding=1, **dd)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = CastLinear(ch0, tdim, **dd)
        self.time_embedding.linear_2 = CastLinear(tdim, tdim, **dd)
        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(down_block_types):
            out = chans[i]
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(res(ch, out))
                ch = out
                if kind == "CrossAttnDownBlock2D":
                    attns.append(transformer(ch, heads[i]))
                skips.append(ch)
            down = None
            if i != n - 1:
                down = [Downsample(ch, dtype, device)]
                skips.append(ch)
            self.down_blocks.append(UNetBlock(resnets, attns, down))
        self.mid_block = UNetBlock([res(ch, ch), res(ch, ch)],
                                   [transformer(ch, heads[-1])])
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(up_block_types):
            out = chans[n - 1 - i]
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(res(ch + skips.pop(), out))
                ch = out
                if kind == "CrossAttnUpBlock2D":
                    attns.append(transformer(ch, heads[n - 1 - i]))
            up = [Upsample(ch, ch, **dd)] if i != n - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attns, upsamplers=up))
        self.conv_norm_out = FusedNormAct(ch, device=device)
        self.conv_out = CastConv2d(ch, out_channels, 3, padding=1,
                                   dtype=torch.float32, device=device)

    def _transformer(self, name: str, block: SpatialTransformer,
                     h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        spans.mark("transformer.in")
        b, tokens = h.shape[0], h.shape[2] * h.shape[3]
        inner = block.transformer_blocks[0]
        self.attn_decisions[name] = inner.attn1.decision(b, tokens, tokens,
                                                         h.dtype)
        self.xattn_decisions[name] = inner.attn2.decision(
            b, tokens, context.shape[1], h.dtype)
        h = block(h, context)
        spans.mark("transformer.out")
        return h

    def forward(self, x: torch.Tensor, t, context: torch.Tensor
                ) -> torch.Tensor:
        b = x.shape[0]
        t = torch.broadcast_to(torch.as_tensor(t, device=x.device), (b,))
        emb = timestep_embedding(t.float(), self.conv_in.out_channels)
        emb = self.time_embedding.linear_1(emb.to(self.dtype))
        emb = self.time_embedding.linear_2(F.silu(emb))
        ctx = context.to(self.dtype)

        h = self.conv_in(x.permute(0, 3, 1, 2).to(self.dtype))
        hs = [h]
        for i, block in enumerate(self.down_blocks):
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, emb)
                if hasattr(block, "attentions"):
                    h = self._transformer(f"down_blocks.{i}.attentions.{j}",
                                          block.attentions[j], h, ctx)
                hs.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                hs.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb)
        h = self._transformer("mid_block.attentions.0", mid.attentions[0], h,
                              ctx)
        h = mid.resnets[1](h, emb)
        for i, block in enumerate(self.up_blocks):
            for j, resnet in enumerate(block.resnets):
                h = resnet(channels_last(torch.cat([h, hs.pop()], dim=1)),
                           emb)
                if hasattr(block, "attentions"):
                    h = self._transformer(f"up_blocks.{i}.attentions.{j}",
                                          block.attentions[j], h, ctx)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        h = self.conv_norm_out(h)
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


LDM_KEYS = ("in_channels", "out_channels", "block_out_channels",
            "layers_per_block", "down_block_types", "up_block_types",
            "attention_head_dim", "cross_attention_dim", "norm_num_groups",
            "norm_eps")
# published keys whose values this module implements and does not take
FIXED = {"use_linear_projection": True, "flip_sin_to_cos": True,
         "freq_shift": 0}


def create_ldm_unet(dtype=torch.bfloat16, device="cuda",
                    **config) -> LDMUNet:
    """An `LDMUNet` from diffusers' `UNet2DConditionModel` config keys
    (`LDM_KEYS`; `sample_size` is accepted and not needed; the keys in
    `FIXED` must hold their values there)."""
    for key, want in FIXED.items():
        if config.pop(key, want) != want:
            raise NotImplementedError(f"{key} must be {want!r}")
    config.pop("sample_size", None)
    unknown = set(config) - set(LDM_KEYS)
    if unknown:
        raise ValueError(f"unknown config keys {sorted(unknown)}")
    return LDMUNet(dtype=dtype, device=device, **config)
