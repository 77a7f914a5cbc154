"""The plain reference of FLUX.1 Fill [dev]'s transformer and its Euler
chain: fp32 PyTorch, no kernels, TF32 off.

diffusers' `FluxTransformer2DModel` at the configuration's keys, written
from the layer equations (C = heads x d, LN without affine at eps 1e-6,
RMSNorm over each head's d at eps 1e-6 with a learned weight):

  temb  = MLP_t(sin(1000 s)) + MLP_g(sin(1000 g)) + MLP_p(pooled),
          MLP = linear_2(SiLU(linear_1(.))), sin(t) = [cos, sin](t 10^(-4 i/128))
  mod(h; sh, sc) = LN(h) (1 + sc) + sh, the vectors from Linear(SiLU(temb))
  attention(q, k, v) = softmax(R(RMS(q)) R(RMS(k))^T / sqrt(d)) v per head,
          R the rotation of adjacent pairs by the tokens' angles
  double block: per stream (sh1, sc1, g1, sh2, sc2, g2); q, k, v of
          mod(h; sh1, sc1) by the stream's own projections; one attention
          over [txt; img]; h += g1 out_s(attn_s);
          h += g2 W2 GELU_tanh(W1 mod(h; sh2, sc2))
  single block on z = [txt; img]: (sh, sc, g); n = mod(z; sh, sc);
          z += g proj_out([attn(n); GELU_tanh(proj_mlp(n))])
  out   = proj_out(mod(img; sh, sc)), (sc, sh) = Linear(SiLU(temb))

RoPE angles: ids (0, row, col) for the image tokens, zeros for the text
(first), pos_a * 10000^(-2j/d_a) per axis, cos and sin in float64 rounded
to fp32, applied as x cos + rot(x) sin with rot(x)_2j = -x_2j+1,
rot(x)_2j+1 = x_2j. The chain: Euler on diffusers' shifted sigma grid
(`sigmas`), x <- x + (s_k+1 - s_k) v(x, s_k) in fp32, the Fill condition
[packed masked latent, packed mask] concatenated to x before every call.

The weights are one bf16 draw from the seed (`draw_weights`: weights
N(0, 1/fan_in), biases N(0, 0.02^2), RMSNorm weights 1 + N(0, 0.1^2),
each parameter drawn on the device in fp32 and rounded), which the system
loads too; this module keeps them in bf16 and takes each weight to fp32
at its use, so the whole model fits in 24 GB beside fp32 activations.
Attention runs in blocks of `QUERY_BLOCK` queries. Submodules carry
diffusers' state-dict names. `lowp` (`reference/lowp.py`) rounds the
operands of every product, the linear layers' and attention's: the
control.
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

EPS = 1e-6
QUERY_BLOCK = 1024


class Linear(nn.Linear):
    """bf16 storage, fp32 product."""
    lowp = None

    def __init__(self, cin, cout, device=None):
        super().__init__(cin, cout, dtype=torch.bfloat16, device=device)

    def forward(self, x):
        w = self.weight.float()
        if self.lowp is not None:
            x, w = self.lowp(x), self.lowp(w)
        return F.linear(x, w, self.bias.float())


class RMSNorm(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.bfloat16,
                                              device=device))

    def forward(self, x):
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS)
                * self.weight.float())


def layer_norm(x):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS)


def modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def sinusoid(t, dim=256):
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_tables(text_tokens: int, h: int, w: int, axes, device):
    """(cos, sin) [T, d] fp32, each angle repeated for its pair."""
    ids = np.zeros((text_tokens + h * w, 3))
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ids[text_tokens:, 1], ids[text_tokens:, 2] = rows.ravel(), cols.ravel()
    ang = np.concatenate(
        [np.outer(ids[:, a], 1.0 / 10_000.0 ** (np.arange(0, d, 2) / d))
         for a, d in enumerate(axes)], axis=1).repeat(2, axis=1)
    return tuple(torch.from_numpy(f(ang).astype(np.float32)).to(device)
                 for f in (np.cos, np.sin))


def rotate(x, cos, sin):
    """x [B, H, T, d] with each adjacent pair rotated."""
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).flatten(-2)
    return x * cos + rot * sin


class Attend(nn.Module):
    """softmax(q k^T / sqrt(d)) v on [B, H, T, d], in blocks of queries."""
    lowp = None

    def forward(self, q, k, v):
        low = self.lowp or (lambda t: t)
        k, v = low(k), low(v)
        out = []
        for at in range(0, q.shape[2], QUERY_BLOCK):
            s = low(q[:, :, at:at + QUERY_BLOCK]) @ k.transpose(-1, -2)
            p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
            out.append(low(p) @ v)
        return torch.cat(out, dim=2)


class Attention(nn.Module):
    def __init__(self, dim, heads, joint, device=None):
        super().__init__()
        self.heads = heads
        d = dim // heads
        self.to_q, self.to_k, self.to_v = (Linear(dim, dim, device)
                                           for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(d, device), RMSNorm(d, device)
        if joint:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                Linear(dim, dim, device) for _ in range(3))
            self.norm_added_q = RMSNorm(d, device)
            self.norm_added_k = RMSNorm(d, device)
            self.to_out = nn.ModuleList([Linear(dim, dim, device)])
            self.to_add_out = Linear(dim, dim, device)
        self.attend = Attend()

    def split(self, x):
        b, t, c = x.shape
        return x.view(b, t, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, z, rope, txt=None):
        q = self.norm_q(self.split(self.to_q(z)))
        k = self.norm_k(self.split(self.to_k(z)))
        v = self.split(self.to_v(z))
        if txt is not None:
            q = torch.cat([self.norm_added_q(self.split(self.add_q_proj(txt))),
                           q], dim=2)
            k = torch.cat([self.norm_added_k(self.split(self.add_k_proj(txt))),
                           k], dim=2)
            v = torch.cat([self.split(self.add_v_proj(txt)), v], dim=2)
        o = self.attend(rotate(q, *rope), rotate(k, *rope), v)
        b, h, t, d = o.shape
        o = o.transpose(1, 2).reshape(b, t, h * d)
        if txt is None:
            return o
        s = txt.shape[1]
        return self.to_add_out(o[:, :s]), self.to_out[0](o[:, s:])


class Mod(nn.Module):
    def __init__(self, dim, n, device=None):
        super().__init__()
        self.n = n
        self.linear = Linear(dim, n * dim, device)

    def forward(self, act):
        return self.linear(act).chunk(self.n, dim=-1)


class GELUProj(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.proj = Linear(cin, cout, device)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, 4 * dim, device),
                                  nn.Identity(), Linear(4 * dim, dim, device)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class DoubleBlock(nn.Module):
    def __init__(self, dim, heads, device=None):
        super().__init__()
        self.norm1 = Mod(dim, 6, device)
        self.norm1_context = Mod(dim, 6, device)
        self.attn = Attention(dim, heads, True, device)
        self.ff = FeedForward(dim, device)
        self.ff_context = FeedForward(dim, device)

    def forward(self, txt, img, act, rope):
        sh1, sc1, g1, sh2, sc2, g2 = self.norm1(act)
        ch1, cc1, cg1, ch2, cc2, cg2 = self.norm1_context(act)
        a_txt, a_img = self.attn(modulate(img, sh1, sc1), rope,
                                 txt=modulate(txt, ch1, cc1))
        img = img + g1[:, None] * a_img
        txt = txt + cg1[:, None] * a_txt
        img = img + g2[:, None] * self.ff(modulate(img, sh2, sc2))
        txt = txt + cg2[:, None] * self.ff_context(modulate(txt, ch2, cc2))
        return txt, img


class SingleBlock(nn.Module):
    def __init__(self, dim, heads, device=None):
        super().__init__()
        self.norm = Mod(dim, 3, device)
        self.proj_mlp = Linear(dim, 4 * dim, device)
        self.proj_out = Linear(5 * dim, dim, device)
        self.attn = Attention(dim, heads, False, device)

    def forward(self, z, act, rope):
        sh, sc, g = self.norm(act)
        n = modulate(z, sh, sc)
        mlp = F.gelu(self.proj_mlp(n), approximate="tanh")
        return z + g[:, None] * self.proj_out(
            torch.cat([self.attn(n, rope), mlp], dim=-1))


class Embed(nn.Module):
    def __init__(self, cin, dim, device=None):
        super().__init__()
        self.linear_1 = Linear(cin, dim, device)
        self.linear_2 = Linear(dim, dim, device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Flux(nn.Module):
    """model(x [B, N, in_channels], sigma, guidance (floats), ctx [B, S,
    joint_attention_dim], pooled [B, pooled_projection_dim], (h, w)) ->
    the velocity [B, N, out_channels], fp32."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        heads, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
        dim = heads * d
        self.axes = cfg["axes_dims_rope"]
        self.x_embedder = Linear(cfg["in_channels"], dim, device)
        self.context_embedder = Linear(cfg["joint_attention_dim"], dim,
                                       device)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = Embed(256, dim, device)
        self.time_text_embed.guidance_embedder = Embed(256, dim, device)
        self.time_text_embed.text_embedder = Embed(
            cfg["pooled_projection_dim"], dim, device)
        self.transformer_blocks = nn.ModuleList(
            [DoubleBlock(dim, heads, device)
             for _ in range(cfg["num_layers"])])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleBlock(dim, heads, device)
             for _ in range(cfg["num_single_layers"])])
        self.norm_out = nn.Module()
        self.norm_out.linear = Linear(dim, 2 * dim, device)
        self.proj_out = Linear(dim, cfg["out_channels"], device)

    def set_lowp(self, lowp) -> "Flux":
        for m in self.modules():
            if isinstance(m, (Linear, Attend)):
                m.lowp = lowp
        return self

    def forward(self, x, sigma: float, guidance: float, ctx, pooled, hw):
        b, n = x.shape[:2]
        emb = self.time_text_embed
        full = torch.full((b,), 1000.0, device=x.device)
        act = F.silu(emb.timestep_embedder(sinusoid(full * sigma))
                     + emb.guidance_embedder(sinusoid(full * guidance))
                     + emb.text_embedder(pooled.float()))
        img = self.x_embedder(x.float())
        txt = self.context_embedder(ctx.float())
        rope = rope_tables(txt.shape[1], *hw, self.axes, x.device)
        for block in self.transformer_blocks:
            txt, img = block(txt, img, act, rope)
        z = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            z = block(z, act, rope)
        sc, sh = self.norm_out.linear(act).chunk(2, dim=-1)
        return self.proj_out(modulate(z[:, txt.shape[1]:], sh, sc))


def draw_weights(cfg: dict, seed: int, device):
    """(name, bf16 tensor) for every parameter of the model of `cfg`, in
    its order: each drawn N(0, 1) in fp32 on `device` from the seed's
    weight stream, one parameter a call, scaled (weights 1/sqrt(fan_in),
    biases 0.02, RMSNorm weights 1 + 0.1 N) and rounded to bf16."""
    with torch.device("meta"):
        shape = Flux(cfg)
    norms = {n for n, m in shape.named_modules() if isinstance(m, RMSNorm)}
    gen = generator(seed, WEIGHTS, device)
    for name, p in shape.named_parameters():
        v = torch.randn(p.shape, generator=gen, device=device)
        owner, kind = name.rsplit(".", 1)
        if owner in norms:
            v = v * 0.1 + 1.0
        elif kind == "weight":
            v = v / p.shape[1] ** 0.5
        else:
            v = v * 0.02
        yield name, v.to(torch.bfloat16)


@torch.no_grad()
def load_weights(model: nn.Module, cfg: dict, seed: int, device) -> None:
    """Copy the seed's draw into `model`'s parameters of the same names."""
    params = dict(model.named_parameters())
    for name, v in draw_weights(cfg, seed, device):
        params.pop(name).copy_(v)
    if params:
        raise KeyError(f"parameters the draw does not cover: {sorted(params)}")


def reference_flux(cfg: dict, seed: int, device, lowp=None) -> Flux:
    ref = Flux(cfg, device=device)
    load_weights(ref, cfg, seed, device)
    return ref.set_lowp(lowp).requires_grad_(False)


def sigmas(num_steps: int, image_tokens: int, sched: dict) -> np.ndarray:
    """diffusers' dynamic-shift grid: num_steps + 1 sigmas from 1 to 0,
    float64 (`np.linspace`, then e^mu / (e^mu + 1/s - 1))."""
    m = ((sched["max_shift"] - sched["base_shift"])
         / (sched["max_image_seq_len"] - sched["base_image_seq_len"]))
    mu = sched["base_shift"] + m * (image_tokens - sched["base_image_seq_len"])
    s = np.linspace(1.0, 1.0 / num_steps, num_steps)
    return np.append(math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0)), 0.0)


def pack(x):
    """[B, C, H, W] -> [B, H/2 * W/2, 4C], channels (c, dy, dx)."""
    b, c, h, w = x.shape
    out = torch.empty((b, h // 2, w // 2, c, 2, 2), dtype=x.dtype,
                      device=x.device)
    for dy in range(2):
        for dx in range(2):
            out[..., dy, dx] = x[:, :, dy::2, dx::2].permute(0, 2, 3, 1)
    return out.reshape(b, (h // 2) * (w // 2), 4 * c)


def fill_condition(mask, latent, scale: int = 8):
    """[packed masked-image latent, packed mask]: the pixel mask [B, 1,
    8H, 8W] folded into 64 channels (dy, dx) at latent resolution first."""
    b, _, hh, ww = mask.shape
    folded = torch.stack([mask[:, 0, dy::scale, dx::scale]
                          for dy in range(scale) for dx in range(scale)],
                         dim=1)
    return torch.cat([pack(latent.float()), pack(folded.float())], dim=-1)


@torch.no_grad()
def velocity(model, x, sigma: float, cond, ctx, pooled, guidance, hw):
    return model(torch.cat([x.float(), cond], dim=-1), sigma, guidance, ctx,
                 pooled, hw)


@torch.no_grad()
def euler_chain(model, x_T, cond, ctx, pooled, guidance: float, grid,
                hw):
    """The Euler chain on `grid` (fp32 values) from packed x_T. Returns
    (its end, the first step's velocity)."""
    x, first = x_T.float(), None
    for k in range(len(grid) - 1):
        v = velocity(model, x, float(grid[k]), cond, ctx, pooled, guidance,
                     hw)
        first = v if first is None else first
        x = x + (float(grid[k + 1]) - float(grid[k])) * v
    return x, first
