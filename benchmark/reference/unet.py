"""The plain reference UNet: fp32 PyTorch, no kernels, no caches.

A guided-diffusion UNet ("Improved Denoising Diffusion Probabilistic
Models", arXiv:2102.09672; the reference project's
`amortised diffusion/image_diffusion/unet.py`) with FiLM time conditioning,
written from the layer equations:

  ResBlock(x, emb) = skip(x) + conv2(SiLU(GN2(conv1(SiLU(GN1(x))))
                     * (1 + scale) + shift)),  (scale, shift) = W_e SiLU(emb)
  Attention(x)     = x + proj(softmax(q k^T / sqrt(d)) v),
                     (q, k, v) = qkv(GN(x)) split as [3, heads, d]
  Downsample       = 3x3 conv, stride 2, padding (0, 1) ("SAME")
  Upsample         = nearest x2, then 3x3 conv

Submodules carry the names the system under test uses for its parameters
(`enc_0_0`, `mid_attn`, `dec_attn_1_2`, ...), so one dict of tensors loads
into both. Images are NHWC at the interface, NCHW inside. `lowp` (a
`reference/lowp.py` quantiser) rounds the operands of every conv and
linear product: the control that runs the same model in a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("full", "encode", "decode")


def num_groups(channels: int, most: int = 32) -> int:
    """The largest group count <= `most` that divides the channels."""
    g = min(most, channels)
    while channels % g:
        g -= 1
    return g


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids [B, dim] in [cos, sin] order, periods up to 10^4."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Conv(nn.Conv2d):
    lowp = None

    def forward(self, x):
        w = self.weight
        if self.lowp is not None:
            x, w = self.lowp(x), self.lowp(w)
        return self._conv_forward(x, w, self.bias)


class Linear(nn.Linear):
    lowp = None

    def forward(self, x):
        w = self.weight
        if self.lowp is not None:
            x, w = self.lowp(x), self.lowp(w)
        return F.linear(x, w, self.bias)


class Norm(nn.GroupNorm):
    def __init__(self, channels: int, device=None):
        super().__init__(num_groups(channels), channels, eps=1e-5,
                         device=device)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int, device=None):
        super().__init__()
        self.cout = cout
        self.in_norm = Norm(cin, device)
        self.in_conv = Conv(cin, cout, 3, padding=1, device=device)
        self.emb_dense = Linear(emb_dim, 2 * cout, device=device)
        self.out_norm = Norm(cout, device)
        self.out_conv = Conv(cout, cout, 3, padding=1, device=device)
        self.skip = (Conv(cin, cout, 1, device=device) if cin != cout
                     else None)

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        e = self.emb_dense(F.silu(emb))
        scale, shift = e[:, :self.cout, None, None], e[:, self.cout:, None,
                                                        None]
        h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


class Attention(nn.Module):
    def __init__(self, channels: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm = Norm(channels, device)
        self.qkv = Linear(channels, 3 * channels, device=device)
        self.proj = Linear(channels, channels, device=device)

    def forward(self, x):
        b, c, h, w = x.shape
        d = c // self.heads
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.qkv(y).reshape(b, h * w, 3, self.heads, d).unbind(2)
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, k),
                          dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, h * w, c)
        return x + self.proj(out).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Down(nn.Module):
    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, device=device)

    def forward(self, x):
        return self.conv(F.pad(x, [0, 1, 0, 1]))


class Up(nn.Module):
    def __init__(self, ch: int, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def heads_of(channels: int, num_heads: int, num_head_channels: int) -> int:
    return (channels // num_head_channels if num_head_channels > 0
            else num_heads)


class UNet(nn.Module):
    """model(x [B, H, W, Cin], t [B]) -> eps [B, H, W, Cout], fp32.

    `cfg` holds the configuration file's sizes: image_size, in_channels,
    out_channels, num_channels, channel_mult, num_res_blocks,
    attention_resolutions (in pixels), num_heads, num_head_channels."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        ch0 = cfg["num_channels"]
        self.ch0 = ch0
        self.mult = tuple(cfg["channel_mult"])
        self.nres = cfg["num_res_blocks"]
        self.attn_ds = {cfg["image_size"] // r
                        for r in cfg["attention_resolutions"]}
        tdim = 4 * ch0

        def heads(ch):
            return heads_of(ch, cfg["num_heads"], cfg["num_head_channels"])

        self.time_dense_0 = Linear(ch0, tdim, device=device)
        self.time_dense_1 = Linear(tdim, tdim, device=device)
        self.conv_in = Conv(cfg["in_channels"], ch0, 3, padding=1,
                            device=device)
        chans, ch, ds = [ch0], ch0, 1
        for lv, m in enumerate(self.mult):
            for i in range(self.nres):
                self.add_module(f"enc_{lv}_{i}",
                                ResBlock(ch, m * ch0, tdim, device))
                ch = m * ch0
                if ds in self.attn_ds:
                    self.add_module(f"enc_attn_{lv}_{i}",
                                    Attention(ch, heads(ch), device))
                chans.append(ch)
            if lv != len(self.mult) - 1:
                self.add_module(f"down_{lv}", Down(ch, device))
                chans.append(ch)
                ds *= 2
        self.top_ds = ds
        self.mid_res_0 = ResBlock(ch, ch, tdim, device)
        self.mid_attn = Attention(ch, heads(ch), device)
        self.mid_res_1 = ResBlock(ch, ch, tdim, device)
        for lv, m in reversed(list(enumerate(self.mult))):
            for i in range(self.nres + 1):
                self.add_module(f"dec_{lv}_{i}",
                                ResBlock(ch + chans.pop(), m * ch0, tdim,
                                         device))
                ch = m * ch0
                if ds in self.attn_ds:
                    self.add_module(f"dec_attn_{lv}_{i}",
                                    Attention(ch, heads(ch), device))
                if lv and i == self.nres:
                    self.add_module(f"up_{lv}", Up(ch, device))
                    ds //= 2
        self.out_norm = Norm(ch, device)
        self.conv_out = Conv(ch, cfg["out_channels"], 3, padding=1,
                             device=device)

    def set_lowp(self, lowp) -> "UNet":
        for m in self.modules():
            if isinstance(m, (Conv, Linear)):
                m.lowp = lowp
        return self

    def forward(self, x, t, mode: str = "full", cache=None):
        """mode "full": eps. "encode": the (bottleneck, skips) cache.
        "decode": eps from such a cache, with this t's embedding."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        emb = timestep_embedding(torch.broadcast_to(t, (x.shape[0],)),
                                 self.ch0)
        emb = self.time_dense_1(F.silu(self.time_dense_0(emb)))
        if mode == "decode":
            h, hs = cache[0], list(cache[1])
            ds = self.top_ds
        else:
            h = self.conv_in(x.permute(0, 3, 1, 2))
            hs, ds = [h], 1
            for lv in range(len(self.mult)):
                for i in range(self.nres):
                    h = getattr(self, f"enc_{lv}_{i}")(h, emb)
                    if ds in self.attn_ds:
                        h = getattr(self, f"enc_attn_{lv}_{i}")(h)
                    hs.append(h)
                if lv != len(self.mult) - 1:
                    h = getattr(self, f"down_{lv}")(h)
                    hs.append(h)
                    ds *= 2
            if mode == "encode":
                return h, tuple(hs)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, emb)), emb)
        for lv in reversed(range(len(self.mult))):
            for i in range(self.nres + 1):
                h = getattr(self, f"dec_{lv}_{i}")(
                    torch.cat([h, hs.pop()], dim=1), emb)
                if ds in self.attn_ds:
                    h = getattr(self, f"dec_attn_{lv}_{i}")(h)
                if lv and i == self.nres:
                    h = getattr(self, f"up_{lv}")(h)
                    ds //= 2
        return self.conv_out(F.silu(self.out_norm(h))).permute(0, 2, 3, 1)

