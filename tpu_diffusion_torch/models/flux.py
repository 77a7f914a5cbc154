"""FLUX.1 Fill [dev]'s rectified-flow transformer, in PyTorch.

No JAX counterpart: the JAX package runs pixel-space UNets only. This is
diffusers' `FluxTransformer2DModel` as Black Forest Labs' FLUX.1 Fill [dev]
configures it (`transformer/config.json`: 19 double-stream and 38
single-stream blocks, 24 heads of 128, T5 context of 4096, CLIP pooled
vector of 768, a guidance embedding, RoPE over axes of 16, 56 and 56),
written from its layer equations. Tokens are the latent packed 2x2
(`pack_latents`: [B, 16, H, W] -> [B, H/2 * W/2, 64], channel order (c, dy,
dx)); the Fill input is [x, the masked image's latent, the mask]
(`pack_mask`: the pixel mask folded 8x8 into 64 channels, then packed),
384 channels.

  temb  = MLP_t(sin(1000 s)) + MLP_g(sin(1000 g)) + MLP_p(pooled)
          (each Linear, SiLU, Linear; the sinusoid in [cos, sin] order)
  mod(h; sh, sc) = LN(h) (1 + sc) + sh   (LN without affine, eps 1e-6)
  double block, streams img and txt with their own weights:
      (sh1, sc1, g1, sh2, sc2, g2) = Linear(SiLU(temb)) per stream
      q, k, v = Linear(mod(h; sh1, sc1)); q, k per-head RMSNorm
      attention over [txt; img] with RoPE on q and k, split back
      h += g1 out_s(attn_s);  h += g2 W2 GELU_tanh(W1 mod(h; sh2, sc2))
  single block on z = [txt; img]:
      (sh, sc, g) = Linear(SiLU(temb)); n = mod(z; sh, sc)
      z += g proj_out([attn(n); GELU_tanh(proj_mlp(n))])
  out   = proj_out(mod(img; sh, sc)), (sc, sh) = Linear(SiLU(temb))

RoPE: position ids (0, row, col) for the image tokens and zeros for the
text tokens, text first; angles pos * 10000^(-2i/d_a) per axis a, adjacent
pairs rotated (x_2i, x_2i+1) -> (x_2i cos - x_2i+1 sin, x_2i sin +
x_2i+1 cos). The table is built once per (text tokens, H, W, device) and
kept on the device.

Parameters and compute in `dtype` (bf16 on the card, the checkpoint's
type; 11,902,391,360 parameters at the published widths): the residual
streams, GEMMs and modulations in bf16; LayerNorm statistics in fp32
(`F.layer_norm`); the per-head RMSNorm and RoPE of q and k in fp32,
rounded once, into the [B*H, T, d] layout of the flash forward
(`kernels/attention.py:flash_attention`, whichever route
`flash_fwd_route` gives: "mma" at d = 128). On the CPU the plain versions.
Parameter names are diffusers' state-dict keys
(`transformer_blocks.0.attn.add_q_proj.weight`, ...), so a released
checkpoint would load by name. Nothing syncs with the host and every
shape is static, so a step captures as one CUDA graph.

`attn_decisions` maps each block's name to its kind, its attention's
route and [BH, T, d] shape and the text/image split, as of its last call.
Each block marks its entry and exit ("flux.double.in", "flux.double.out",
"flux.single.in", "flux.single.out", `utils/spans.py:mark`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.kernels.attention import (flash_attention,
                                                   flash_fwd_route)
from tpu_diffusion_torch.models.nn import timestep_embedding
from tpu_diffusion_torch.models.unet import resolve_device
from tpu_diffusion_torch.utils import spans

EPS = 1e-6  # the LayerNorms' and the RMSNorms'
TIME_DIM = 256  # the sinusoid of the timestep and the guidance
TIME_SCALE = 1000.0  # sigma in [0, 1] and the guidance, scaled before it
ROPE_THETA = 10_000.0
MLP_RATIO = 4


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H/2 * W/2, 4C]: 2x2 patches as tokens in
    row-major order, channels in (c, dy, dx) order."""
    b, c, h, w = x.shape
    return x.view(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5) \
        .reshape(b, (h // 2) * (w // 2), 4 * c)


def pack_mask(mask: torch.Tensor, scale: int = 8) -> torch.Tensor:
    """A pixel mask [B, 1, scale*H, scale*W] -> [B, H/2 * W/2, 4 scale^2]:
    each latent pixel's scale x scale block as channels (dy, dx), then
    packed as a latent (diffusers' `FluxFillPipeline.prepare_mask_latents`)."""
    b, _, hh, ww = mask.shape
    h, w = hh // scale, ww // scale
    m = mask[:, 0].reshape(b, h, scale, w, scale).permute(0, 2, 4, 1, 3)
    return pack_latents(m.reshape(b, scale * scale, h, w))


def position_ids(text_tokens: int, h: int, w: int, device) -> torch.Tensor:
    """[text_tokens + h*w, 3] ids: zeros for the text, (0, row, col) for
    the image tokens in row-major order."""
    ids = torch.zeros((text_tokens + h * w, 3), dtype=torch.float64,
                      device=device)
    ids[text_tokens:, 1] = torch.arange(h, device=device).repeat_interleave(w)
    ids[text_tokens:, 2] = torch.arange(w, device=device).repeat(h)
    return ids


def rope_table(ids: torch.Tensor, axes_dims: Sequence[int],
               theta: float = ROPE_THETA) -> torch.Tensor:
    """[T, 1, d/2] complex64 rotations e^(i angle) of each token's
    adjacent pairs: per axis a, pos_a * theta^(-2j/d_a) for j < d_a/2, the
    axes concatenated; angles, cos and sin in float64, then rounded."""
    parts = []
    for a, d in enumerate(axes_dims):
        freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                             device=ids.device) / d)
        parts.append(ids[:, a:a + 1].double() * freqs[None])
    angles = torch.cat(parts, dim=-1)
    return torch.polar(torch.ones_like(angles), angles).to(
        torch.complex64)[:, None, :]


def apply_rope(y: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """y [B, T, H, d] fp32 with each adjacent pair rotated by `rope`
    [T, 1, d/2] (a complex product: x_2i + i x_2i+1 times e^(i angle))."""
    return torch.view_as_real(torch.view_as_complex(
        y.unflatten(-1, (-1, 2))) * rope).flatten(-2)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """LN(x) (1 + scale) + shift: LayerNorm without affine (fp32
    statistics, eps 1e-6), shift and scale [B, 1, C]."""
    n = F.layer_norm(x, (x.shape[-1],), eps=EPS)
    return torch.addcmul(shift, n, 1 + scale)


class RMSNorm(nn.Module):
    """Per-head RMSNorm with a learned weight over the last axis: the
    result in fp32, not rounded (RoPE follows in fp32)."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight.float(),
                          EPS)


def _heads(parts, norms, heads: int, rope: torch.Tensor,
           dtype) -> torch.Tensor:
    """The flash forward's [B*H, T, d] operand in `dtype` from the streams'
    projections [B, T_s, H*d], concatenated in order along the tokens;
    with `norms`, each stream's per-head RMSNorm and RoPE in fp32 first,
    rounded once as it is copied into the heads' layout."""
    b, c = parts[0].shape[0], parts[0].shape[-1]
    d, t = c // heads, sum(p.shape[1] for p in parts)
    out = torch.empty((b, heads, t, d), dtype=dtype, device=parts[0].device)
    at = 0
    for p, norm in zip(parts, norms or (None,) * len(parts)):
        n = p.shape[1]
        y = p.unflatten(-1, (heads, d))
        if norm is not None:
            y = apply_rope(norm(y), rope[at:at + n])
        out[:, :, at:at + n].copy_(y.transpose(1, 2))
        at += n
    return out.view(b * heads, t, d)


def _merge(o: torch.Tensor, b: int, heads: int) -> torch.Tensor:
    """[B*H, T, d] -> [B, T, H*d]."""
    _, t, d = o.shape
    return o.view(b, heads, t, d).transpose(1, 2).reshape(b, t, heads * d)


class Attention(nn.Module):
    """q, k, v projections with bias and per-head RMSNorms of q and k;
    with `joint`, the text stream's own (`add_*_proj`, `norm_added_*`) and
    the two output projections (`to_out.0` for the image, `to_add_out` for
    the text) of a double-stream block."""

    def __init__(self, dim: int, heads: int, joint: bool, dtype, device):
        super().__init__()
        self.heads = heads
        dd = dict(dtype=dtype, device=device)
        d = dim // heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim, **dd)
                                           for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(d, **dd), RMSNorm(d, **dd)
        if joint:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                nn.Linear(dim, dim, **dd) for _ in range(3))
            self.norm_added_q = RMSNorm(d, **dd)
            self.norm_added_k = RMSNorm(d, **dd)
            self.to_out = nn.ModuleList([nn.Linear(dim, dim, **dd)])
            self.to_add_out = nn.Linear(dim, dim, **dd)

    def attend(self, q, k, v, rope) -> torch.Tensor:
        """(q, k, v): per projection, (the streams' projections, their
        norms); returns [B, T, H*d]."""
        h, dtype = self.heads, q[0][0].dtype
        o = flash_attention(_heads(*q, h, rope, dtype),
                            _heads(*k, h, rope, dtype),
                            _heads(*v, h, rope, dtype))
        return _merge(o, q[0][0].shape[0], h)

    def joint(self, txt, img, rope):
        """The double-stream attention: (text out, image out)."""
        o = self.attend(
            ([self.add_q_proj(txt), self.to_q(img)],
             [self.norm_added_q, self.norm_q]),
            ([self.add_k_proj(txt), self.to_k(img)],
             [self.norm_added_k, self.norm_k]),
            ([self.add_v_proj(txt), self.to_v(img)], None), rope)
        s = txt.shape[1]
        return self.to_add_out(o[:, :s]), self.to_out[0](o[:, s:])

    def forward(self, z, rope):
        """The single-stream attention, no output projection."""
        return self.attend(([self.to_q(z)], [self.norm_q]),
                           ([self.to_k(z)], [self.norm_k]),
                           ([self.to_v(z)], None), rope)

    def decision(self, b: int, t: int, dtype) -> dict:
        bh, d = b * self.heads, self.to_q.out_features // self.heads
        route = (flash_fwd_route(bh, t, d, dtype)
                 if self.to_q.weight.is_cuda else "plain")
        return {"route": route, "bh": bh, "t": t, "d": d}


class AdaNorm(nn.Module):
    """`linear`: the n modulation vectors [B, 1, C] of Linear(SiLU(temb))
    (SiLU applied once by the caller)."""

    def __init__(self, dim: int, n: int, dtype, device):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim, dtype=dtype, device=device)

    def forward(self, act: torch.Tensor):
        return self.linear(act)[:, None].chunk(self.n, dim=-1)


class GELUProj(nn.Module):
    def __init__(self, cin: int, cout: int, dtype, device):
        super().__init__()
        self.proj = nn.Linear(cin, cout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """`net`: Linear C -> 4C with GELU (tanh), nothing (diffusers' dropout
    slot), Linear 4C -> C."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.net = nn.ModuleList([
            GELUProj(dim, MLP_RATIO * dim, dtype, device), nn.Identity(),
            nn.Linear(MLP_RATIO * dim, dim, dtype=dtype, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class DoubleBlock(nn.Module):
    """diffusers' `FluxTransformerBlock`: two streams, each with its own
    modulation, projections and MLP, joined in one attention."""

    def __init__(self, dim: int, heads: int, dtype, device):
        super().__init__()
        dd = dict(dtype=dtype, device=device)
        self.norm1 = AdaNorm(dim, 6, **dd)
        self.norm1_context = AdaNorm(dim, 6, **dd)
        self.attn = Attention(dim, heads, True, **dd)
        self.ff = FeedForward(dim, **dd)
        self.ff_context = FeedForward(dim, **dd)

    def forward(self, txt, img, act, rope):
        sh1, sc1, g1, sh2, sc2, g2 = self.norm1(act)
        ch1, cc1, cg1, ch2, cc2, cg2 = self.norm1_context(act)
        a_txt, a_img = self.attn.joint(modulate(txt, ch1, cc1),
                                       modulate(img, sh1, sc1), rope)
        img = torch.addcmul(img, g1, a_img)
        txt = torch.addcmul(txt, cg1, a_txt)
        img = torch.addcmul(img, g2, self.ff(modulate(img, sh2, sc2)))
        txt = torch.addcmul(txt, cg2, self.ff_context(modulate(txt, ch2,
                                                               cc2)))
        return txt, img


class SingleBlock(nn.Module):
    """diffusers' `FluxSingleTransformerBlock`: attention and MLP in
    parallel on one stream, one output projection over both."""

    def __init__(self, dim: int, heads: int, dtype, device):
        super().__init__()
        dd = dict(dtype=dtype, device=device)
        self.norm = AdaNorm(dim, 3, **dd)
        self.proj_mlp = nn.Linear(dim, MLP_RATIO * dim, **dd)
        self.proj_out = nn.Linear((1 + MLP_RATIO) * dim, dim, **dd)
        self.attn = Attention(dim, heads, False, **dd)

    def forward(self, z, act, rope):
        sh, sc, g = self.norm(act)
        n = modulate(z, sh, sc)
        mlp = F.gelu(self.proj_mlp(n), approximate="tanh")
        return torch.addcmul(z, g, self.proj_out(torch.cat(
            [self.attn(n, rope), mlp], dim=-1)))


class MLPEmbed(nn.Module):
    """Linear, SiLU, Linear (`linear_1`, `linear_2`)."""

    def __init__(self, cin: int, dim: int, dtype, device):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class FluxTransformer(nn.Module):
    """model(x [B, N, in_channels] packed tokens (the Fill channels
    concatenated), timestep [B] sigma in [0, 1], guidance [B], context
    [B, S, joint_attention_dim], pooled [B, pooled_projection_dim], size
    (H/2, W/2) of the token grid) -> the velocity [B, N, out_channels],
    fp32."""

    def __init__(self, in_channels: int = 384, out_channels: int = 64,
                 num_layers: int = 19, num_single_layers: int = 38,
                 attention_head_dim: int = 128,
                 num_attention_heads: int = 24,
                 joint_attention_dim: int = 4096,
                 pooled_projection_dim: int = 768,
                 axes_dims_rope: Sequence[int] = (16, 56, 56),
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        if sum(axes_dims_rope) != attention_head_dim:
            raise ValueError(f"axes_dims_rope {list(axes_dims_rope)} must "
                             f"sum to attention_head_dim "
                             f"{attention_head_dim}")
        device = resolve_device(device)
        dim = num_attention_heads * attention_head_dim
        dd = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.heads = num_attention_heads
        self.axes_dims_rope = tuple(axes_dims_rope)
        self.attn_decisions: dict = {}
        self._ropes: dict = {}
        self.x_embedder = nn.Linear(in_channels, dim, **dd)
        self.context_embedder = nn.Linear(joint_attention_dim, dim, **dd)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = MLPEmbed(TIME_DIM, dim, **dd)
        self.time_text_embed.guidance_embedder = MLPEmbed(TIME_DIM, dim, **dd)
        self.time_text_embed.text_embedder = MLPEmbed(pooled_projection_dim,
                                                      dim, **dd)
        self.transformer_blocks = nn.ModuleList(
            [DoubleBlock(dim, num_attention_heads, **dd)
             for _ in range(num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleBlock(dim, num_attention_heads, **dd)
             for _ in range(num_single_layers)])
        self.norm_out = nn.Module()
        self.norm_out.linear = nn.Linear(dim, 2 * dim, **dd)
        self.proj_out = nn.Linear(dim, out_channels, **dd)

    def rope(self, text_tokens: int, h: int, w: int, device) -> torch.Tensor:
        key = (text_tokens, h, w, str(device))
        if key not in self._ropes:
            self._ropes[key] = rope_table(
                position_ids(text_tokens, h, w, device), self.axes_dims_rope)
        return self._ropes[key]

    def _embed(self, timestep, guidance, pooled) -> torch.Tensor:
        """SiLU(temb) [B, C], which every modulation takes."""
        emb = self.time_text_embed
        temb = (emb.timestep_embedder(timestep_embedding(
            TIME_SCALE * timestep.float(), TIME_DIM).to(self.dtype))
            + emb.guidance_embedder(timestep_embedding(
                TIME_SCALE * guidance.float(), TIME_DIM).to(self.dtype))
            + emb.text_embedder(pooled.to(self.dtype)))
        return F.silu(temb)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor,
                guidance: torch.Tensor, context: torch.Tensor,
                pooled: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        b, n = x.shape[:2]
        h, w = size
        act = self._embed(timestep, guidance, pooled)
        img = self.x_embedder(x.to(self.dtype))
        txt = self.context_embedder(context.to(self.dtype))
        s = txt.shape[1]
        rope = self.rope(s, h, w, x.device)
        for i, block in enumerate(self.transformer_blocks):
            spans.mark("flux.double.in")
            self.attn_decisions[f"transformer_blocks.{i}"] = dict(
                kind="double", txt=s, img=n,
                **block.attn.decision(b, s + n, img.dtype))
            txt, img = block(txt, img, act, rope)
            spans.mark("flux.double.out")
        z = torch.cat([txt, img], dim=1)
        for i, block in enumerate(self.single_transformer_blocks):
            spans.mark("flux.single.in")
            self.attn_decisions[f"single_transformer_blocks.{i}"] = dict(
                kind="single", txt=s, img=n,
                **block.attn.decision(b, s + n, z.dtype))
            z = block(z, act, rope)
            spans.mark("flux.single.out")
        sc, sh = self.norm_out.linear(act)[:, None].chunk(2, dim=-1)
        return self.proj_out(modulate(z[:, s:], sh, sc)).float()

    def velocity(self, guidance: float, context: torch.Tensor,
                 pooled: torch.Tensor, size: Tuple[int, int]):
        """v(t, x) for `sampling/ode.py`'s integrators: t a 0-d sigma, x
        [B, N, in_channels]; the guidance embedding at `guidance`, and
        `context` and `pooled` read at each call by address (a caller that
        overwrites them in place changes every later call, a captured one
        included)."""
        def v(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
            b = x.shape[0]
            g = torch.full((b,), guidance, dtype=torch.float32,
                           device=x.device)
            return self(x, t.expand(b), g, context, pooled, size)
        return v


FLUX_KEYS = ("in_channels", "out_channels", "num_layers",
             "num_single_layers", "attention_head_dim",
             "num_attention_heads", "joint_attention_dim",
             "pooled_projection_dim", "axes_dims_rope")
# published keys whose values this module implements and does not take
FIXED = {"patch_size": 1, "guidance_embeds": True}


def create_flux(dtype=torch.bfloat16, device="cuda",
                **config) -> FluxTransformer:
    """A `FluxTransformer` from diffusers' `FluxTransformer2DModel` config
    keys (`FLUX_KEYS`; the keys in `FIXED` must hold their values)."""
    for key, want in FIXED.items():
        if config.pop(key, want) != want:
            raise NotImplementedError(f"{key} must be {want!r}")
    unknown = set(config) - set(FLUX_KEYS)
    if unknown:
        raise ValueError(f"unknown config keys {sorted(unknown)}")
    return FluxTransformer(dtype=dtype, device=device, **config)
