"""A whole ResBlock forward: the hand-written CUDA kernels and a plain version.

Counterpart of `tpu_diffusion/kernels/resblock.py` (`fused_resblock`,
`resblock_reference`), for inference only (on the card an input that needs
a gradient raises, `kernels.refuse_grad`):

    h   = silu(GN1(x))
    h   = conv3x3(h, w1) + b1
    h   = silu(GN2(h) * emb_scale + emb_shift)    (FiLM mode)
          or silu(GN2(h + emb_shift))             (additive, emb_scale=None)
    h   = conv3x3(h, w2) + b2
    out = (x  or  x . wskip + bskip) + h

on NHWC x with HWIO weights (the JAX package's layouts) and fp32 group
statistics. The Dense(silu(emb)) projection stays with the caller, which
passes `emb_scale = 1 + scale`. A CPU tensor goes to `resblock_reference`;
a CUDA tensor goes to `csrc/resblock.cu`, on the route that
`resblock_route` names, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.kernels import refuse_grad
from tpu_diffusion_torch.kernels.build import load_library

# Calls of `fused_resblock` that launched its kernels since the count was
# last set to 0: one per call, whichever route. A call is the chain of
# kernels that computes one ResBlock: GN1's partial sums
# (`gn_partial_kernel`), then on the "wgmma" route `gn_act_kernel` and
# `conv3x3_wgmma_kernel` for each conv (five launches), on "mma" and
# "scalar" `conv3x3_kernel` for each (three).
launches = 0

# The routes, in the order of the C entry point's `route`.
ROUTES = ("scalar", "mma", "wgmma")
GN_CHUNK = 128  # pixels per partial sum of GN1 (`gn_partial_kernel`)
TILE_PIXELS = 128  # pixels per block of the "mma" and "scalar" routes
MAX_CHANNELS = 1024
MAX_GROUPS = 32
WGMMA_WIDTHS = (8, 16, 32, 64)  # image widths the "wgmma" route takes


class Geometry(NamedTuple):
    """A route's conv blocks: `tile_pixels` pixels (whole image rows) by
    `channel_tile` output channels each."""
    tile_pixels: int
    channel_tile: int


def resblock_route(b: int, h: int, w: int, cin: int, cout: int,
                   dtype: torch.dtype) -> tuple[str, Geometry]:
    """The conv kernel that runs a [b, h, w, cin] -> cout call on the card,
    and its tile geometry: "wgmma" (bf16, w in WGMMA_WIDTHS, 256 / w
    dividing h, Cin % 32 = 0, Cout % 128 = 0: warp-specialised, weights by
    TMA, products by `wgmma`; 256 x 128 tiles), "mma" (the other bf16
    shapes: `mma.sync`) or "scalar" (fp32); both 128 pixels by 128 channels,
    or 64 where Cout is not a multiple of 128. The C entry point refuses a
    route or a geometry that does not fit the call."""
    if (dtype == torch.bfloat16 and w in WGMMA_WIDTHS and h % (256 // w) == 0
            and cin % 32 == 0 and cout % 128 == 0
            and max(cin, cout) <= MAX_CHANNELS):
        return "wgmma", Geometry(256, 128)
    route = "mma" if dtype == torch.bfloat16 else "scalar"
    return route, Geometry(TILE_PIXELS, 64 if cout % 128 else 128)


def scratch_shapes(b: int, h: int, w: int, cin: int, cout: int, g1: int,
                   g2: int, route: str, geometry: Geometry):
    """Shapes of the scratch tensors: GN1's fp32 partial sums per (image,
    GN_CHUNK pixels, group) and GN2's per (image, conv tile, channel tile,
    group), (sum, sum of squares) last; on the "wgmma" route also the bf16
    activation that each conv reads (silu(GN(input)), [b, h, w, max(Cin,
    Cout)]), else None."""
    return ((b, -(-h * w // GN_CHUNK), g1, 2),
            (b, h * w // geometry.tile_pixels, cout // geometry.channel_tile,
             g2, 2),
            (b, h, w, max(cin, cout)) if route == "wgmma" else None)


def buffers(b: int, h: int, w: int, cin: int, cout: int, g1: int, g2: int,
            dtype: torch.dtype, device: torch.device):
    """The route and geometry of a call, and the tensors its launch writes:
    (route, geometry, mid, out, partials1, partials2, act or None)."""
    route, geometry = resblock_route(b, h, w, cin, cout, dtype)
    shape1, shape2, shape_act = scratch_shapes(b, h, w, cin, cout, g1, g2,
                                               route, geometry)
    mid = torch.empty((b, h, w, cout), dtype=dtype, device=device)
    out = torch.empty_like(mid)
    partials1 = torch.empty(shape1, dtype=torch.float32, device=device)
    partials2 = torch.empty(shape2, dtype=torch.float32, device=device)
    act = (None if shape_act is None else
           torch.empty(shape_act, dtype=dtype, device=device))
    return route, geometry, mid, out, partials1, partials2, act


def _num_groups(c: int, groups: int = 32) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def resblock_reference(x, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
                       emb_scale, emb_shift, w2, b2, wskip=None, bskip=None,
                       *, eps: float = 1e-5, groups: int = 32):
    """Plain version: fp32 GroupNorm, convolutions with fp32 accumulation
    of operands rounded to x's type, and the activations rounded to x's
    type after each SiLU, as the JAX package's mirror does."""
    b, h, w, _ = x.shape

    def gn(z, gamma, beta):
        c = z.shape[-1]
        g = _num_groups(c, groups)
        zf = z.float().reshape(b, h * w, g, c // g)
        mean = zf.mean(dim=(1, 3), keepdim=True)
        var = zf.var(dim=(1, 3), keepdim=True, unbiased=False)
        y = ((zf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
        return y * gamma.float() + beta.float()

    def conv(z, wk, bk):
        # z: NHWC in x's type; wk: HWIO, rounded to x's type first
        out = F.conv2d(z.float().permute(0, 3, 1, 2),
                       wk.to(z.dtype).float().permute(3, 2, 0, 1), padding=1)
        return out.permute(0, 2, 3, 1) + bk.float()

    y = F.silu(gn(x, gn1_scale, gn1_bias)).to(x.dtype)
    hmid = conv(y, w1, b1)  # fp32 NHWC
    if emb_scale is not None:
        h2 = gn(hmid, gn2_scale, gn2_bias)
        h2 = (h2 * emb_scale.float()[:, None, None, :]
              + emb_shift.float()[:, None, None, :])
    else:
        h2 = gn(hmid + emb_shift.float()[:, None, None, :], gn2_scale,
                gn2_bias)
    h2 = F.silu(h2).to(x.dtype)
    out = conv(h2, w2, b2)
    if wskip is not None:
        skip = x.float() @ wskip.to(x.dtype).float() + bskip.float()
    else:
        skip = x.float()
    return (skip + out).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("resblock").resblock_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 17 + [i] * 7 + [ctypes.c_float] + [i] * 4 + [p, p]
    fn.restype = ctypes.c_int
    return fn


def fused_resblock(x: torch.Tensor, gn1_scale: torch.Tensor,
                   gn1_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   gn2_scale: torch.Tensor, gn2_bias: torch.Tensor,
                   emb_scale: torch.Tensor | None, emb_shift: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   wskip: torch.Tensor | None = None,
                   bskip: torch.Tensor | None = None, *, eps: float = 1e-5,
                   groups: int = 32) -> torch.Tensor:
    """x: [B, H, W, Cin]; w1: [3, 3, Cin, Cout]; w2: [3, 3, Cout, Cout];
    wskip: [Cin, Cout] or None (identity skip, Cin == Cout); emb_scale,
    emb_shift: [B, Cout], emb_scale=None for the additive mode; the other
    vectors [Cin] or [Cout]. Returns [B, H, W, Cout] in x's type."""
    cin, cout = x.shape[-1], w1.shape[-1]
    if w1.shape != (3, 3, cin, cout) or w2.shape != (3, 3, cout, cout):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
                         f"not fit x {tuple(x.shape)} (HWIO expected)")
    if (wskip is None) != (bskip is None):
        raise ValueError("wskip and bskip come together")
    if wskip is None and cin != cout:
        raise ValueError(f"identity skip needs Cin == Cout, got {cin}, {cout}")
    if wskip is not None and wskip.shape != (cin, cout):
        raise ValueError(f"wskip must be [{cin}, {cout}], got "
                         f"{tuple(wskip.shape)}")
    args = (x, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, emb_scale,
            emb_shift, w2, b2, wskip, bskip)
    if x.device.type == "cpu":
        return resblock_reference(*args, eps=eps, groups=groups)
    return _launch(*args, eps=eps, groups=groups)


def _launch(x, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, emb_scale,
            emb_shift, w2, b2, wskip, bskip, *, eps, groups):
    global launches
    refuse_grad("fused_resblock", x, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                gn2_bias, emb_scale, emb_shift, w2, b2, wskip, bskip)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned "
                         "[B, H, W, C] tensor")
    b, h, w, cin = x.shape
    cout = w1.shape[-1]
    g1, g2 = _num_groups(cin, groups), _num_groups(cout, groups)
    if (w <= 0 or TILE_PIXELS % w or h % (TILE_PIXELS // w) or cin % 32
            or cout % 64 or max(cin, cout) > MAX_CHANNELS
            or max(g1, g2) > MAX_GROUPS or not 0 < b <= 65535):
        raise ValueError(
            f"unsupported shape: x {tuple(x.shape)} -> {cout} channels with "
            f"{g1}/{g2} groups (the kernel needs W to divide {TILE_PIXELS}, "
            f"H a multiple of {TILE_PIXELS} / W, Cin a multiple of 32, Cout "
            f"of 64, both <= {MAX_CHANNELS}, at most {MAX_GROUPS} groups)")
    for name, v in (("w1", w1), ("w2", w2), ("wskip", wskip)):
        if v is not None and (v.device != x.device or v.dtype != x.dtype
                              or not v.is_contiguous()
                              or v.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous {x.dtype} tensor "
                             f"on {x.device}")

    def vec(name, v, shape):
        if v.device != x.device or v.shape != shape:
            raise ValueError(f"{name} must be a {list(shape)} tensor on "
                             f"{x.device}, got {list(v.shape)}")
        return v.float().contiguous()  # no copy for a contiguous fp32 one

    gn1_scale = vec("gn1_scale", gn1_scale, (cin,))
    gn1_bias = vec("gn1_bias", gn1_bias, (cin,))
    gn2_scale = vec("gn2_scale", gn2_scale, (cout,))
    gn2_bias = vec("gn2_bias", gn2_bias, (cout,))
    b1, b2 = vec("b1", b1, (cout,)), vec("b2", b2, (cout,))
    emb_shift = vec("emb_shift", emb_shift, (b, cout))
    if emb_scale is not None:
        emb_scale = vec("emb_scale", emb_scale, (b, cout))
    if bskip is not None:
        bskip = vec("bskip", bskip, (cout,))
    route, geometry, mid, out, partials1, partials2, act = buffers(
        b, h, w, cin, cout, g1, g2, x.dtype, x.device)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(x.device):
        err = _entry()(
            ptr(x), ptr(gn1_scale), ptr(gn1_bias), ptr(w1), ptr(b1),
            ptr(gn2_scale), ptr(gn2_bias), ptr(emb_scale), ptr(emb_shift),
            ptr(w2), ptr(b2), ptr(wskip), ptr(bskip), ptr(mid), ptr(out),
            ptr(partials1), ptr(partials2), b, h, w, cin, cout, g1, g2, eps,
            int(x.dtype == torch.bfloat16), ROUTES.index(route), *geometry,
            ptr(act), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"resblock launch failed: cudaError {err} for x "
                           f"{tuple(x.shape)} -> {cout} channels on the "
                           f"{route!r} route")
    launches += 1
    return out
