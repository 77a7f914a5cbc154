"""GroupNorm(+FiLM)+SiLU: the hand-written CUDA kernels and their plain version.

Counterpart of `tpu_diffusion/kernels/groupnorm.py:fused_groupnorm_silu`:
`act(GN(x) * gamma * (1 + scale) + beta * (1 + scale) + shift)` with fp32
group statistics, on NHWC x. A CPU tensor goes to `reference_groupnorm_silu`;
a CUDA tensor goes to `csrc/groupnorm_silu.cu` or raises. `gn_route` picks
the kernel: "cluster" (one launch; a cluster of blocks holds each image in
shared memory) where the image fits, else "two_pass" (statistics, then
apply).

The JAX kernel has no backward; this one has a hand-written one, so that
the trained UNet can take the kernel: where an input needs a gradient, the
call goes through `_GroupNormAct`, whose forward also writes each (image,
group)'s mean and rstd and whose backward (`csrc/groupnorm_silu.cu`, the
plain version `reference_groupnorm_silu_backward`) takes the route
`gn_bwd_route` picks: "cluster" (x and dy of each image in a cluster's
shared memory, one read of each) or "two_pass" (sums, then dx). Under
`torch.no_grad()` the call is the plain launch, with no statistics.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.kernels import refuse_grad
from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by `fused_groupnorm_silu` since the count was last
# set to 0: one per call, whichever route (the two-pass route's stats and
# apply passes count once together).
launches = 0
# Backward launches, one per backward call whichever route (its passes and
# the batch sum of dgamma, dbeta count once together).
backward_launches = 0

ACTS = ("silu", "none")


def reference_groupnorm_silu(x, gamma, beta, scale=None, shift=None,
                             num_groups=32, eps=1e-5, act="silu"):
    """Plain fp32 version of the same function; output in x's type."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xf - mean) / torch.sqrt(var + eps)).reshape(b, h, w, c)
    y = xn * gamma.float() + beta.float()
    if scale is not None:
        y = (y * (1.0 + scale.float())[:, None, None, :]
             + shift.float()[:, None, None, :])
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def group_stats(x, num_groups=32, eps=1e-5):
    """[B, G, 2] fp32 mean and rstd of each (image, group) of NHWC x, as the
    forward kernel writes them for the backward."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = ((xf - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def reference_groupnorm_silu_backward(dy, x, gamma, beta, scale, shift,
                                      stats, num_groups=32, act="silu"):
    """Plain fp32 version of the backward kernel's arithmetic: (dx, dgamma,
    dbeta, dscale, dshift) from dy and the forward's `stats`, through the
    sums S1 = sum dz and S2 = sum dz * xhat over each image's pixels."""
    b, h, w, c = x.shape
    cg = c // num_groups
    st = stats.repeat_interleave(cg, dim=1)[:, None, None, :, :]
    xh = (x.float() - st[..., 0]) * st[..., 1]
    sc = (torch.ones((b, c), device=x.device) if scale is None
          else 1.0 + scale.float())[:, None, None, :]
    sh = 0.0 if shift is None else shift.float()[:, None, None, :]
    z = (xh * gamma.float() + beta.float()) * sc + sh
    dz = dy.float()
    if act == "silu":
        s = torch.sigmoid(z)
        dz = dz * s * (1 + z * (1 - s))
    s1, s2 = dz.sum(dim=(1, 2)), (dz * xh).sum(dim=(1, 2))  # [B, C]
    sc = sc[:, 0, 0, :]
    g1 = (gamma * sc * s1).reshape(b, num_groups, cg).sum(-1) / (h * w * cg)
    g2 = (gamma * sc * s2).reshape(b, num_groups, cg).sum(-1) / (h * w * cg)
    m1 = g1.repeat_interleave(cg, dim=1)[:, None, None, :]
    m2 = g2.repeat_interleave(cg, dim=1)[:, None, None, :]
    dx = st[..., 1] * (gamma * sc[:, None, None, :] * dz - m1 - xh * m2)
    dscale = dshift = None
    if scale is not None:
        dscale = (gamma * s2 + beta * s1).to(scale.dtype)
        dshift = s1.to(shift.dtype)
    return (dx.to(x.dtype), (sc * s2).sum(0), (sc * s1).sum(0), dscale,
            dshift)


class _GroupNormAct(torch.autograd.Function):
    """The kernel under autograd: the forward launch also writes the
    statistics; the backward is the backward kernel. Saves x (already live
    as its producer's output), the parameters, the FiLM terms and the
    [B, G, 2] statistics; not the output, and no fp32 copy."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, eps, act):
        stats = torch.empty((x.shape[0], num_groups, 2), dtype=torch.float32,
                            device=x.device)
        y = _launch(x, gamma, beta, scale, shift, num_groups, eps, act,
                    stats=stats)
        ctx.save_for_backward(x, gamma, beta, scale, shift, stats)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, scale, shift, stats = ctx.saved_tensors
        grads = _launch_backward(dy.contiguous(), x, gamma, beta, scale,
                                 shift, stats, ctx.num_groups, ctx.act)
        return tuple(g if need else None for g, need
                     in zip(grads, ctx.needs_input_grad)) + (None,) * 3


@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("groupnorm_silu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    two_pass, cluster = lib.groupnorm_silu, lib.groupnorm_silu_cluster
    bwd, bwd_cluster = lib.groupnorm_silu_bwd, lib.groupnorm_silu_bwd_cluster
    two_pass.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, i, i, i, i, f,
                         i, i, p]
    cluster.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, i, f, i, i, p]
    bwd.argtypes = [p] * 7 + [i] + [p] * 8 + [i] * 9 + [p]
    bwd_cluster.argtypes = [p] * 7 + [i] + [p] * 6 + [i] * 8 + [p]
    for fn in (two_pass, cluster, bwd, bwd_cluster):
        fn.restype = ctypes.c_int
    return two_pass, cluster, bwd, bwd_cluster


def fused_groupnorm_silu(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, scale: torch.Tensor | None = None,
                         shift: torch.Tensor | None = None,
                         num_groups: int = 32, eps: float = 1e-5,
                         act: str = "silu") -> torch.Tensor:
    """x: [B, H, W, C]; gamma/beta: [C]; scale/shift: [B, C] or None."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(
            f"channels {c} not divisible by num_groups={num_groups}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    if x.device.type == "cpu":
        return reference_groupnorm_silu(x, gamma, beta, scale, shift,
                                        num_groups, eps, act)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, scale, shift)):
        return _GroupNormAct.apply(x, gamma, beta, scale, shift, num_groups,
                                   eps, act)
    return _launch(x, gamma, beta, scale, shift, num_groups, eps, act)


def launch_geometry(c: int, hw: int, itemsize: int):
    """(rows, pixels per chunk, chunks) of the two-pass route's blocks: each
    block has (C / vec) * rows threads (vec elements per 16-byte load) and
    covers `pixels per chunk` pixels of one image, 4 per thread."""
    cv = c // (16 // itemsize)
    rows = max(1, 256 // cv)
    pix = rows * 4
    return rows, pix, -(-hw // pix)


CLUSTER_SIZES = (1, 2, 4, 8)  # portable cluster sizes
CHUNK_MAX = 192 * 1024     # bytes of x a cluster-route block holds at most
SMEM_MAX = 232448          # a block's shared memory on the H100
SMS = 132                  # the H100 SXM's SMs


def cluster_smem(c: int, hw: int, itemsize: int, cluster: int, rows: int,
                 num_groups: int = 32) -> int:
    """Shared-memory bytes of a cluster-route block: its pixels of x, a
    float4 of sums per thread, 2 x G float2 statistics, 4 mbarriers."""
    threads = c // (16 // itemsize) * rows
    return hw // cluster * c * itemsize + 16 * threads + 16 * num_groups + 32


def _cluster_rows(cv: int, threads: int) -> int:
    """Rows of a cluster-route block: (C / vec) * rows threads, the largest
    multiple of 32 up to `threads`; 0 if there is none."""
    rows = max(1, threads // cv)
    while rows and cv * rows % 32:
        rows -= 1
    return rows


def gn_route(b: int, hw: int, c: int, itemsize: int, num_groups: int = 32,
             sms: int = SMS):
    """("cluster", (cluster size, rows)) or ("two_pass", launch_geometry).

    The cluster route runs each image on `cluster` blocks of (C / vec) *
    rows threads, each holding hw / cluster pixels (at most CHUNK_MAX
    bytes) in shared memory. Of the cluster sizes that fit, it takes the
    one with the fewest waves of blocks over the card's `sms` SMs; within
    one wave the smallest whose blocks fill the card (else the largest),
    within several waves the one with the most blocks per SM. Blocks have
    about 512 threads in a single wave, and 256 for chunks under 32 KB and
    in several waves where 256 is a multiple of C / vec (measured on the
    H100: PERF.md). An image too large for eight blocks, or channels the
    kernel cannot fold, take the two-pass route."""
    vec = 16 // itemsize
    cv, cg = c // vec, c // num_groups
    # the kernel folds a thread's vec channels into at most two groups
    two_groups = all((v * vec + vec - 1) // cg - v * vec // cg <= 1
                     for v in range(cv))
    best = None
    for n in CLUSTER_SIZES:
        chunk = hw // n * c * itemsize
        if (hw % n or chunk > CHUNK_MAX or not two_groups
                or not 0 < b <= 65535):
            continue
        for threads in ((512, 256) if chunk >= 32 * 1024 else (256,)):
            rows = _cluster_rows(cv, threads)
            smem = cluster_smem(c, hw, itemsize, n, rows, num_groups)
            if not rows or num_groups > cv * rows or smem > SMEM_MAX:
                continue
            per_sm = min(SMEM_MAX // smem, 2048 // (cv * rows))
            waves = -(-b * n // (sms * per_sm))
            # 256 threads only where they split the channels evenly
            if waves == 1 or threads == 256 or 256 % cv:
                break
        else:
            continue
        if waves == 1:
            fills = b * n >= 0.9 * sms
            key = (1, 0 if fills else 1, n if fills else -n)
        else:
            key = (waves, 0, -per_sm)
        if best is None or key < best[0]:
            best = (key, n, rows)
    if best is not None:
        return "cluster", (best[1], best[2])
    return "two_pass", launch_geometry(c, hw, itemsize)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x, gamma, beta, scale, shift, num_groups, eps, act, stats=None):
    """The forward kernel; with `stats` ([B, G, 2] fp32) it also writes each
    (image, group)'s mean and rstd there."""
    global launches
    refuse_grad("the forward launch of fused_groupnorm_silu", x, gamma, beta,
                scale, shift, hint="or call fused_groupnorm_silu, which "
                                   "differentiates it")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned "
                         "[B, H, W, C] tensor")
    b, h, w, c = x.shape
    vec = 16 // x.element_size()
    # at most 512 threads across C (the cluster kernel's block; one row of
    # them in the two-pass route, whose stats pass's [2, rows, C] fp32
    # reduction buffer then stays within 32 KB of shared memory)
    if c % vec or c // vec > 512 or not 0 < b <= 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)} for {x.dtype}")
    for name, v in (("gamma", gamma), ("beta", beta)):
        if (v.device != x.device or v.dtype != torch.float32
                or v.shape != (c,) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 [C] tensor "
                             f"on {x.device}")
    film_stride = 0
    if scale is not None:
        if scale.stride() != shift.stride():
            raise ValueError("scale and shift must share their strides")
        for name, v in (("scale", scale), ("shift", shift)):
            if (v.device != x.device or v.dtype != x.dtype
                    or v.shape != (b, c) or v.stride(1) != 1):
                raise ValueError(f"{name} must be a [B, C] {x.dtype} tensor "
                                 f"on {x.device} with unit channel stride")
        film_stride = scale.stride(0)
    route, geometry = gn_route(b, h * w, c, x.element_size(), num_groups,
                               _sms(x.device))
    out = torch.empty_like(x)
    common = (x.data_ptr(), out.data_ptr(), gamma.data_ptr(),
              beta.data_ptr(), _ptr(scale), _ptr(shift), film_stride,
              _ptr(stats))
    flags = (eps, int(act == "silu"), int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if route == "cluster":
            err = _entries()[1](*common, b, h * w, c, num_groups, *geometry,
                                *flags)
        else:
            rows, pix, nchunk = geometry
            partials = torch.empty((b, nchunk, num_groups, 2),
                                   dtype=torch.float32, device=x.device)
            err = _entries()[0](*common, partials.data_ptr(), b, h * w, c,
                                num_groups, rows, pix, nchunk, *flags)
    if err:
        raise RuntimeError(f"groupnorm_silu ({route}) launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


BWD_VEC = 4         # channels of a backward thread
BWD_THREADS = 256   # threads of a backward block, at most (C / 4 if more)
BWD_PIXELS = 16     # pixels per thread of a two-pass chunk, at least
BWD_CHUNKS = 32     # two-pass chunks of an image, at most
# bytes of an image's x and dy up to which the backward takes the cluster
# route: above it, where the cluster route runs one block of at most 256
# threads per SM, the two-pass route's many blocks were faster on the H100
# (PERF.md)
BWD_CLUSTER_MAX = 256 * 1024


def bwd_geometry(c: int, hw: int, itemsize: int):
    """(rows, pixels per chunk, chunks) of the two-pass backward's blocks of
    (C / BWD_VEC) * rows threads, BWD_PIXELS pixels per thread or more, at
    most BWD_CHUNKS chunks an image (each image's reduction reads all its
    chunks' sums: 128 of them took 31 us at [32, 64, 64, 384])."""
    cv = c // BWD_VEC
    rows = max(1, BWD_THREADS // cv)
    pix = rows * max(BWD_PIXELS, -(-hw // (rows * BWD_CHUNKS)))
    return rows, pix, -(-hw // pix)


def bwd_cluster_smem(c: int, hw: int, itemsize: int, cluster: int, rows: int,
                     num_groups: int = 32) -> int:
    """Shared-memory bytes of a cluster-route backward block: its pixels of
    x and dy, [2, rows, C] fp32 sums, C + G float2."""
    return (2 * (hw // cluster) * c * itemsize + 8 * rows * c
            + 8 * (c + num_groups))


def gn_bwd_route(b: int, hw: int, c: int, itemsize: int,
                 num_groups: int = 32, sms: int = SMS):
    """("cluster", (cluster size, rows)) or ("two_pass", bwd_geometry).

    The cluster route holds each image's x and dy in the shared memory of a
    cluster of 1, 2, 4 or 8 blocks (`bwd_cluster_route`). An image whose x
    and dy exceed BWD_CLUSTER_MAX bytes, or fit no cluster, takes the
    two-pass route: sums over pixel chunks, a per-image reduction, dx."""
    if 2 * hw * c * itemsize <= BWD_CLUSTER_MAX:
        route = bwd_cluster_route(b, hw, c, itemsize, num_groups, sms)
        if route is not None:
            return "cluster", route
    return "two_pass", bwd_geometry(c, hw, itemsize)


def bwd_cluster_route(b: int, hw: int, c: int, itemsize: int,
                      num_groups: int = 32, sms: int = SMS):
    """(cluster size, rows) of the backward's cluster route, or None where
    the image's x and dy do not fit eight blocks' shared memory. Blocks
    have (C / BWD_VEC) * rows threads (at most BWD_THREADS, or C /
    BWD_VEC); of the cluster sizes that fit it takes, as `gn_route` does,
    the fewest waves of blocks over the card's `sms` SMs, within one wave
    the smallest whose blocks fill the card (else the largest), within
    several the most blocks per SM."""
    cv = c // BWD_VEC
    rows = max(1, BWD_THREADS // cv)
    best = None
    for n in CLUSTER_SIZES:
        smem = bwd_cluster_smem(c, hw, itemsize, n, rows, num_groups)
        if hw % n or smem > SMEM_MAX or not 0 < b <= 65535:
            continue
        per_sm = min(SMEM_MAX // smem, 2048 // (cv * rows))
        waves = -(-b * n // (sms * per_sm))
        if waves == 1:
            fills = b * n >= 0.9 * sms
            key = (1, 0 if fills else 1, n if fills else -n)
        else:
            key = (waves, 0, -per_sm)
        if best is None or key < best[0]:
            best = (key, n)
    return None if best is None else (best[1], rows)


def _launch_backward(dy, x, gamma, beta, scale, shift, stats, num_groups,
                     act):
    """The backward kernel: (dx, dgamma, dbeta, dscale, dshift) of the
    forward at x, whose `stats` the forward launch wrote, on the route
    `gn_bwd_route` picks."""
    global backward_launches
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} tensor")
    b, h, w, c = x.shape
    picked = gn_bwd_route(b, h * w, c, x.element_size(), num_groups,
                          _sms(x.device))
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    dscale = dshift = None
    if scale is not None:
        dscale = torch.empty((b, c), dtype=x.dtype, device=x.device)
        dshift = torch.empty_like(dscale)
    f32 = dict(dtype=torch.float32, device=x.device)
    pc = torch.empty((b, c, 2), **f32)
    common = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), gamma.data_ptr(),
              beta.data_ptr(), _ptr(scale), _ptr(shift),
              0 if scale is None else scale.stride(0), stats.data_ptr(),
              _ptr(dscale), _ptr(dshift), pc.data_ptr(), dgamma.data_ptr(),
              dbeta.data_ptr())
    flags = (int(act == "silu"), int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if picked[0] == "cluster":
            err = _entries()[3](*common, b, h * w, c, num_groups, *picked[1],
                                *flags)
        else:
            rows, pix, nchunk = picked[1]
            part = torch.empty((b, nchunk, c, 2), **f32)
            coef = torch.empty((b, num_groups, 2), **f32)
            err = _entries()[2](*common, part.data_ptr(), coef.data_ptr(), b,
                                h * w, c, num_groups, rows, pix, nchunk,
                                *flags)
    if err:
        raise RuntimeError(f"groupnorm_silu backward ({picked[0]}) launch "
                           f"failed: cudaError {err}")
    backward_launches += 1
    return dx, dgamma, dbeta, dscale, dshift
