"""Guided-diffusion style UNet in PyTorch.

Counterpart of `tpu_diffusion/models/unet.py` (`ResBlock`, `AttentionBlock`,
`Downsample`, `Upsample`, `UNetModel`, `create_model`, `attention_ds`).
The public layout is the JAX package's: `model(x_nhwc, t)` returns NHWC
eps, and the encode/decode cache holds NHWC tensors. Internally activations
are NCHW in `channels_last` memory (see `models/nn.py`). Submodules carry
the flax module names (`enc_0_0`, `mid_attn`, `dec_attn_1_2`, ...), so
`convert.py` maps one tree onto the other by name.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.kernels.attention import (flash_attention_fused,
                                                   fused_attention_ref)
from tpu_diffusion_torch.models.nn import (NORM_IMPLS, FusedNormAct,
                                           GroupNorm32, avg_pool_2x,
                                           channels_last, nearest_upsample,
                                           timestep_embedding, zero_init_conv)

ATTENTION_IMPLS = ("fused", "plain")
MODES = ("full", "encode", "decode")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device that is not there
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


class SameConv2d(nn.Conv2d):
    """Conv2d with flax's "SAME" padding, which for a strided conv puts the
    odd padding row and column at the end (bottom/right)."""

    def __init__(self, cin, cout, kernel_size, stride=1, **kw):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=0,
                         **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                           reversed(self.stride)):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def conv3x3(cin: int, cout: int, dtype, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype, device=device)


def make_norm(channels: int, norm_impl: str, norm_dtype, device,
              act: str = "silu") -> nn.Module:
    if norm_impl == "fused":
        return FusedNormAct(channels, act=act, device=device)
    return GroupNorm32(channels, dtype=norm_dtype, device=device)


class ResBlock(nn.Module):
    """Residual block with FiLM (scale-shift) or additive time conditioning."""

    def __init__(self, cin: int, cout: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, dtype=torch.bfloat16, norm_dtype=None,
                 norm_impl: str = "plain", device=None):
        super().__init__()
        self.cout = cout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.fused = norm_impl == "fused"
        self.in_norm = make_norm(cin, norm_impl, norm_dtype, device)
        self.in_conv = conv3x3(cin, cout, dtype, device)
        self.emb_dense = nn.Linear(
            emb_dim, 2 * cout if use_scale_shift_norm else cout, dtype=dtype,
            device=device)
        self.out_norm = make_norm(cout, norm_impl, norm_dtype, device)
        self.out_conv = zero_init_conv(conv3x3(cout, cout, dtype, device))
        self.skip = (nn.Conv2d(cin, cout, 1, dtype=dtype, device=device)
                     if cin != cout else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_norm(x) if self.fused else F.silu(self.in_norm(x))
        if self.up:
            h, x = nearest_upsample(h), nearest_upsample(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_conv(h)
        emb_out = self.emb_dense(F.silu(emb))
        if self.use_scale_shift_norm:
            if self.fused:
                h = self.out_norm(h, film=emb_out)
            else:
                scale = emb_out[:, :self.cout, None, None]
                shift = emb_out[:, self.cout:, None, None]
                h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = h + emb_out[:, :, None, None]
            h = self.out_norm(h) if self.fused else F.silu(self.out_norm(h))
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Self-attention over the H*W tokens of each image."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1, impl: str = "fused",
                 dtype=torch.bfloat16, norm_dtype=None,
                 norm_impl: str = "plain", device=None):
        super().__init__()
        if num_head_channels > 0 and channels % num_head_channels:
            raise ValueError(f"channels {channels} not divisible by "
                             f"num_head_channels={num_head_channels}")
        self.heads = (channels // num_head_channels if num_head_channels > 0
                      else num_heads)
        if channels % self.heads:
            raise ValueError(
                f"channels {channels} not divisible by {self.heads} heads")
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention impl must be one of "
                             f"{ATTENTION_IMPLS}, got {impl!r}")
        self.impl = impl
        self.norm = make_norm(channels, norm_impl, norm_dtype, device,
                              act="none")
        self.qkv = nn.Linear(channels, 3 * channels, dtype=dtype,
                             device=device)
        self.proj = zero_init_conv(nn.Linear(channels, channels, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        qkv = self.qkv(y)  # [b, T, 3c], channel ((s*heads + h)*d + i)
        if self.impl == "fused":
            out = flash_attention_fused(qkv, self.heads)
        else:
            out = fused_attention_ref(qkv, self.heads)
        out = self.proj(out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv = SameConv2d(cin, cout, 3, stride=2, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv = conv3x3(cin, cout, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample(x))


class UNetModel(nn.Module):
    """The denoiser backbone: model(x_nhwc, t) -> [B, H, W, out_channels].

    `attn_decisions` maps each attention block's name to the implementation
    it ran, its token count and head count, as of its last call.
    """

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int = 2,
                 attention_resolutions: Tuple[int, ...] = (),
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 num_heads: int = 1,
                 num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 attention_impl: str = "fused", dtype=torch.bfloat16,
                 norm_dtype=None, norm_impl: str = "plain", device="cuda"):
        super().__init__()
        if norm_impl not in NORM_IMPLS:
            raise ValueError(f"norm_impl must be one of {NORM_IMPLS}, got "
                             f"{norm_impl!r}")
        device = resolve_device(device)
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.resblock_updown = resblock_updown
        self.dtype = dtype
        self.attn_decisions: dict = {}
        ch0 = model_channels
        time_dim = 4 * ch0
        dd = dict(dtype=dtype, device=device)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(
                cin, cout, time_dim, use_scale_shift_norm, dtype=dtype,
                norm_dtype=norm_dtype, norm_impl=norm_impl, device=device,
                **kw))

        def attn(name, ch):
            self.add_module(name, AttentionBlock(
                ch, num_heads, num_head_channels, attention_impl, dtype,
                norm_dtype, norm_impl, device))

        self.time_dense_0 = nn.Linear(ch0, time_dim, **dd)
        self.time_dense_1 = nn.Linear(time_dim, time_dim, **dd)
        self.conv_in = conv3x3(in_channels, ch0, dtype, device)
        chans = [ch0]
        ch, ds = ch0, 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                res(f"enc_{level}_{i}", ch, mult * ch0)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    attn(f"enc_attn_{level}_{i}", ch)
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                if resblock_updown:
                    res(f"down_{level}", ch, ch, down=True)
                else:
                    self.add_module(f"down_{level}", Downsample(ch, ch,
                                                                **dd))
                chans.append(ch)
                ds *= 2
        mid = self.channel_mult[-1] * ch0
        res("mid_res_0", ch, mid)
        attn("mid_attn", mid)
        res("mid_res_1", mid, mid)
        ch = mid
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"dec_{level}_{i}", ch + chans.pop(), mult * ch0)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    attn(f"dec_attn_{level}_{i}", ch)
                if level and i == num_res_blocks:
                    if resblock_updown:
                        res(f"up_{level}", ch, ch, up=True)
                    else:
                        self.add_module(f"up_{level}", Upsample(ch, ch,
                                                                **dd))
                    ds //= 2
        self.out_norm = make_norm(ch, norm_impl, norm_dtype, device)
        self.fused_out_norm = norm_impl == "fused"
        self.conv_out = zero_init_conv(
            conv3x3(ch, out_channels, torch.float32, device))

    def _attn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        self.attn_decisions[name] = {"impl": block.impl,
                                     "tokens": h.shape[2] * h.shape[3],
                                     "heads": block.heads}
        return block(h)

    def forward(self, x: torch.Tensor, t, *, mode: str = "full",
                cache=None):
        """mode="full": the plain forward. mode="encode": the
        `(bottleneck, skips)` cache (NHWC). mode="decode": middle and
        decoder from such a cache, with the current timestep's embedding."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        ch0 = self.model_channels
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = torch.broadcast_to(t, (x.shape[0],))
        emb = timestep_embedding(t, ch0)
        emb = self.time_dense_0(emb.to(self.dtype))
        emb = self.time_dense_1(F.silu(emb))

        if mode in ("full", "encode"):
            h = self.conv_in(x.permute(0, 3, 1, 2).to(self.dtype))
            hs = [h]
            ds = 1
            for level, _ in enumerate(self.channel_mult):
                for i in range(self.num_res_blocks):
                    h = getattr(self, f"enc_{level}_{i}")(h, emb)
                    if ds in self.attention_resolutions:
                        h = self._attn(f"enc_attn_{level}_{i}", h)
                    hs.append(h)
                if level != len(self.channel_mult) - 1:
                    down = getattr(self, f"down_{level}")
                    h = down(h, emb) if self.resblock_updown else down(h)
                    hs.append(h)
                    ds *= 2
            if mode == "encode":
                return (h.permute(0, 2, 3, 1),
                        tuple(s.permute(0, 2, 3, 1) for s in hs))
        else:
            if cache is None:
                raise ValueError("mode='decode' requires cache")
            h = cache[0].permute(0, 3, 1, 2)
            hs = [s.permute(0, 3, 1, 2) for s in cache[1]]
            ds = 2 ** (len(self.channel_mult) - 1)

        h = self.mid_res_0(h, emb)
        h = self._attn("mid_attn", h)
        h = self.mid_res_1(h, emb)
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = channels_last(torch.cat([h, hs.pop()], dim=1))
                h = getattr(self, f"dec_{level}_{i}")(h, emb)
                if ds in self.attention_resolutions:
                    h = self._attn(f"dec_attn_{level}_{i}", h)
                if level and i == self.num_res_blocks:
                    up = getattr(self, f"up_{level}")
                    h = up(h, emb) if self.resblock_updown else up(h)
                    ds //= 2
        if hs:
            raise RuntimeError(f"{len(hs)} skip tensors left unused")
        h = (self.out_norm(h) if self.fused_out_norm
             else F.silu(self.out_norm(h)))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


_DEFAULT_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
    28: (1, 2, 2),
}


def attention_ds(image_size: int, attention_resolutions: str | Sequence[int]
                 ) -> Tuple[int, ...]:
    """Parse "16,8"-style resolution strings into downsample rates."""
    if isinstance(attention_resolutions, str):
        if not attention_resolutions:
            return ()
        resolutions = [int(r) for r in attention_resolutions.split(",")]
    else:
        resolutions = list(attention_resolutions)
    return tuple(image_size // r for r in resolutions)


def create_model(image_size: int, num_channels: int, num_res_blocks: int,
                 in_channels: int = 3, out_channels: int | None = None,
                 channel_mult: Sequence[int] | str = "", num_heads: int = 1,
                 num_head_channels: int = -1,
                 attention_resolutions: str = "16,8",
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 attention_impl: str = "fused", dtype=torch.bfloat16,
                 norm_dtype=None, norm_impl: str = "plain",
                 device="cuda") -> UNetModel:
    if not channel_mult:
        if image_size not in _DEFAULT_CHANNEL_MULT:
            raise ValueError(f"unsupported image size: {image_size}")
        channel_mult = _DEFAULT_CHANNEL_MULT[image_size]
    elif isinstance(channel_mult, str):
        channel_mult = tuple(int(c) for c in channel_mult.split(","))
    return UNetModel(
        in_channels=in_channels, model_channels=num_channels,
        out_channels=out_channels or in_channels,
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds(image_size, attention_resolutions),
        channel_mult=tuple(channel_mult), num_heads=num_heads,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, attention_impl=attention_impl,
        dtype=dtype, norm_dtype=norm_dtype, norm_impl=norm_impl,
        device=device)


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from `generator` (a CPU generator, so a seed
    gives the same weights on every device): weights ~ N(0, 1/fan_in),
    biases ~ N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), norm biases
    N(0, 0.1^2). The zero-initialised output convs are drawn like any
    other, so eps is not identically 0."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, (GroupNorm32, FusedNormAct)):
                v = torch.randn(p.shape, generator=generator) * 0.1
                if name == "weight":
                    v += 1.0
            elif name == "weight":
                fan_in = p[0].numel()
                v = torch.randn(p.shape, generator=generator) / fan_in ** 0.5
            else:
                v = torch.randn(p.shape, generator=generator) * 0.02
            p.copy_(v)
    return model
