"""The plain reference of the Stable Diffusion 2 inpainting UNet and its
guided DDIM chain: fp32 PyTorch, no kernels, TF32 off.

diffusers' `UNet2DConditionModel` at the configuration's keys, written from
the layer equations (heads of 64; `attention_head_dim` is the head count):

  ResBlock(x, emb) = skip(x) + conv2(SiLU(GN(h))),
                     h = conv1(SiLU(GN(x))) + W_e SiLU(emb)
  Transformer(x)   = x + proj_out(B(proj_in(GN_1e-6(x)))) on the H*W tokens,
      B(h): h += attn1(LN(h)); h += attn2(LN(h), ctx);
            h += W2 (a * GELU(g)), (a, g) = split(W1 LN(h))
      attn(h, c) = to_out(softmax(q k^T / 8) v) per head, q = W_q h,
                   k = W_k c, v = W_v c (no bias)
  Downsample       = 3x3 conv, stride 2, padding 1
  Upsample         = nearest x2, then 3x3 conv
  emb              = linear_2(SiLU(linear_1([cos, sin](t * 10^(-4 i / 160)))))

Departures from the released pipeline, each also in the configuration's
`assumed`: the weights come from the seed (`make_weights`), the UNet takes
the integer step, and the chain walks the system's DDIM grid
(i = 980, 960, ..., 0; diffusers' "leading" grid with `steps_offset` 1 is
981, ..., 1), with no clipping of x0 (`clip_sample` false). Submodules
carry diffusers' state-dict names, which the system uses too, so one dict of
tensors loads into both. `lowp` (`reference/lowp.py`) rounds the operands
of every conv and linear product: the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.inputs import WEIGHTS, generator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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


NORMS = (nn.GroupNorm, nn.LayerNorm)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, tdim, device=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-5, device=device)
        self.conv1 = Conv(cin, cout, 3, padding=1, device=device)
        self.time_emb_proj = Linear(tdim, cout, device=device)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-5, device=device)
        self.conv2 = Conv(cout, cout, 3, padding=1, device=device)
        self.conv_shortcut = (Conv(cin, cout, 1, device=device)
                              if cin != cout else None)

    def forward(self, x, emb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, ch, heads, kv_dim, device=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(ch, ch, bias=False, device=device)
        self.to_k = Linear(kv_dim, ch, bias=False, device=device)
        self.to_v = Linear(kv_dim, ch, bias=False, device=device)
        self.to_out = nn.ModuleList([Linear(ch, ch, device=device)])

    def forward(self, h, c):
        b, t, ch = h.shape
        d = ch // self.heads
        q = self.to_q(h).reshape(b, t, self.heads, d)
        k = self.to_k(c).reshape(b, c.shape[1], self.heads, d)
        v = self.to_v(c).reshape(b, c.shape[1], self.heads, d)
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d),
                          dim=-1)
        return self.to_out[0](torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(
            b, t, ch))


class GEGLU(nn.Module):
    def __init__(self, ch, device=None):
        super().__init__()
        self.proj = Linear(ch, 8 * ch, device=device)

    def forward(self, h):
        a, g = self.proj(h).chunk(2, dim=-1)
        return a * F.gelu(g)


class FeedForward(nn.Module):
    def __init__(self, ch, device=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(ch, device), nn.Identity(),
                                  Linear(4 * ch, ch, device=device)])

    def forward(self, h):
        return self.net[2](self.net[0](h))


class Block(nn.Module):
    def __init__(self, ch, heads, ctx_dim, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(ch, eps=1e-5, device=device)
        self.attn1 = Attention(ch, heads, ch, device)
        self.norm2 = nn.LayerNorm(ch, eps=1e-5, device=device)
        self.attn2 = Attention(ch, heads, ctx_dim, device)
        self.norm3 = nn.LayerNorm(ch, eps=1e-5, device=device)
        self.ff = FeedForward(ch, device)

    def forward(self, h, ctx):
        n = self.norm1(h)
        h = h + self.attn1(n, n)
        h = h + self.attn2(self.norm2(h), ctx)
        return h + self.ff(self.norm3(h))


class Transformer(nn.Module):
    def __init__(self, ch, heads, ctx_dim, device=None):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6, device=device)
        self.proj_in = Linear(ch, ch, device=device)
        self.transformer_blocks = nn.ModuleList([Block(ch, heads, ctx_dim,
                                                       device)])
        self.proj_out = Linear(ch, ch, device=device)

    def forward(self, x, ctx):
        b, ch, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, ch)
        h = self.transformer_blocks[0](self.proj_in(h), ctx)
        h = self.proj_out(h).reshape(b, hh, ww, ch).permute(0, 3, 1, 2)
        return x + h


class Sampler(nn.Module):
    def __init__(self, ch, down, device=None):
        super().__init__()
        self.down = down
        self.conv = Conv(ch, ch, 3, stride=2 if down else 1, padding=1,
                         device=device)

    def forward(self, x):
        if not self.down:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class Level(nn.Module):
    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if down:
            self.downsamplers = nn.ModuleList(down)
        if up:
            self.upsamplers = nn.ModuleList(up)


class LDMUNet(nn.Module):
    """model(x [B, H, W, in_channels], t [B] steps, ctx [B, S, ctx_dim]) ->
    eps [B, H, W, out_channels], fp32. `cfg`: the configuration file's
    `model` block (diffusers' keys)."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        chans, heads = cfg["block_out_channels"], cfg["attention_head_dim"]
        layers, ctx_dim = cfg["layers_per_block"], cfg["cross_attention_dim"]
        n, ch0 = len(chans), chans[0]
        self.ch0, tdim = ch0, 4 * ch0
        self.conv_in = Conv(cfg["in_channels"], ch0, 3, padding=1,
                            device=device)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(ch0, tdim, device=device)
        self.time_embedding.linear_2 = Linear(tdim, tdim, device=device)
        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["down_block_types"]):
            res, att = [], []
            for _ in range(layers):
                res.append(ResBlock(ch, chans[i], tdim, device))
                ch = chans[i]
                if kind.startswith("CrossAttn"):
                    att.append(Transformer(ch, heads[i], ctx_dim, device))
                skips.append(ch)
            down = None
            if i < n - 1:
                down = [Sampler(ch, True, device)]
                skips.append(ch)
            self.down_blocks.append(Level(res, att, down=down))
        self.mid_block = Level([ResBlock(ch, ch, tdim, device),
                                ResBlock(ch, ch, tdim, device)],
                               [Transformer(ch, heads[-1], ctx_dim, device)])
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            out = chans[n - 1 - i]
            res, att = [], []
            for _ in range(layers + 1):
                res.append(ResBlock(ch + skips.pop(), out, tdim, device))
                ch = out
                if kind.startswith("CrossAttn"):
                    att.append(Transformer(ch, heads[n - 1 - i], ctx_dim,
                                           device))
            up = [Sampler(ch, False, device)] if i < n - 1 else None
            self.up_blocks.append(Level(res, att, up=up))
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=1e-5, device=device)
        self.conv_out = Conv(ch, cfg["out_channels"], 3, padding=1,
                             device=device)

    def set_lowp(self, lowp) -> "LDMUNet":
        for m in self.modules():
            if isinstance(m, (Conv, Linear)):
                m.lowp = lowp
        return self

    def forward(self, x, t, ctx):
        half = self.ch0 // 2
        freqs = torch.exp(-math.log(10_000.0) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        emb = self.time_embedding.linear_2(F.silu(
            self.time_embedding.linear_1(emb)))
        ctx = ctx.float()
        h = self.conv_in(x.float().permute(0, 3, 1, 2))
        hs = [h]
        for level in self.down_blocks:
            for j, res in enumerate(level.resnets):
                h = res(h, emb)
                if hasattr(level, "attentions"):
                    h = level.attentions[j](h, ctx)
                hs.append(h)
            if hasattr(level, "downsamplers"):
                h = level.downsamplers[0](h)
                hs.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, emb), ctx),
                           emb)
        for level in self.up_blocks:
            for j, res in enumerate(level.resnets):
                h = res(torch.cat([h, hs.pop()], dim=1), emb)
                if hasattr(level, "attentions"):
                    h = level.attentions[j](h, ctx)
            if hasattr(level, "upsamplers"):
                h = level.upsamplers[0](h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: fp32 tensor} for every parameter of the UNet of `cfg`, from
    one normal draw of the seed's weight stream, by `inputs.make_weights`'
    rule: weights N(0, 1 / fan_in), biases N(0, 0.02^2), norm scales (the
    GroupNorms' and LayerNorms') 1 + N(0, 0.1^2), norm shifts N(0, 0.1^2)."""
    with torch.device("meta"):
        shape_model = LDMUNet(cfg)
    norms = {n for n, m in shape_model.named_modules()
             if isinstance(m, NORMS)}
    named = list(shape_model.named_parameters())
    flat = torch.randn(sum(p.numel() for _, p in named),
                       generator=generator(seed, WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for name, p in named:
        v = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        owner, kind = name.rsplit(".", 1)
        if owner in norms:
            v = v * 0.1 + (1.0 if kind == "weight" else 0.0)
        elif kind == "weight":
            v = v / p[0].numel() ** 0.5
        else:
            v = v * 0.02
        out[name] = v.contiguous()
    return out


def reference_unet(cfg: dict, seed: int, device, lowp=None) -> LDMUNet:
    ref = LDMUNet(cfg, device=device)
    ref.load_state_dict(make_weights(cfg, seed, device))
    return ref.set_lowp(lowp).requires_grad_(False)


def scaled_linear_abar(num_steps: int, beta_start: float,
                       beta_end: float) -> np.ndarray:
    """alpha-bar of the scaled-linear betas, linspace(sqrt(start),
    sqrt(end), N)^2, in float64."""
    betas = np.linspace(math.sqrt(beta_start), math.sqrt(beta_end),
                        num_steps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_grid(abar: np.ndarray, ddim_steps: int) -> list:
    """(i, sqrt(abar_prev), sqrt(1 - abar_prev), sqrt(abar), sqrt(1 - abar))
    per step of the deterministic DDIM chain, high noise first, on the grid
    i = k * (N // ddim_steps)."""
    steps = np.arange(ddim_steps) * (len(abar) // ddim_steps)
    a = abar[steps]
    prev = np.concatenate([[1.0], a[:-1]])
    rows = zip(steps, np.sqrt(prev), np.sqrt(1 - prev), np.sqrt(a),
               np.sqrt(1 - a))
    return [tuple(float(v) for v in r) for r in rows][::-1]


@torch.no_grad()
def guided_eps(model, x, i: int, cond, ctx_c, ctx_u, scale: float):
    """eps_u + scale (eps_c - eps_u), each from its own forward on [x,
    cond] with the prompt's or the unconditional context."""
    t = torch.full((x.shape[0],), i, device=x.device)
    xc = torch.cat([x, cond], dim=-1)
    e_c = model(xc, t, ctx_c)
    e_u = model(xc, t, ctx_u.expand(x.shape[0], -1, -1))
    return e_u + scale * (e_c - e_u)


@torch.no_grad()
def ddim_cfg_chain(model, x_T, cond, ctx_c, ctx_u, abar: np.ndarray,
                   ddim_steps: int, scale: float):
    """The guided deterministic DDIM chain from x_T (NHWC latents): x0 =
    (x - sqrt(1 - abar) eps) / sqrt(abar), x' = sqrt(abar_prev) x0 +
    sqrt(1 - abar_prev) eps. Returns (the chain's end, the iterate before
    its last step)."""
    x, last = x_T.float(), None
    for i, sp, sp1, sa, sa1 in ddim_grid(abar, ddim_steps):
        last = x
        eps = guided_eps(model, x, int(i), cond, ctx_c, ctx_u, scale)
        x0 = (x - sa1 * eps) / sa
        x = sp * x0 + sp1 * eps
    return x, last
