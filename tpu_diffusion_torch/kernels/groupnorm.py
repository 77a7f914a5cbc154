"""GroupNorm(+FiLM)+SiLU: the hand-written CUDA kernels and their plain version.

Counterpart of `tpu_diffusion/kernels/groupnorm.py:fused_groupnorm_silu`:
`act(GN(x) * gamma * (1 + scale) + beta * (1 + scale) + shift)` with fp32
group statistics, on NHWC x. A CPU tensor goes to `reference_groupnorm_silu`;
a CUDA tensor goes to `csrc/groupnorm_silu.cu` or raises. `gn_route` picks
the kernel: "cluster" (one launch; a cluster of blocks holds each image in
shared memory) where the image fits, else "two_pass" (statistics, then
apply). The kernel has no backward, as the JAX one has none: on the card an
input that needs a gradient raises (`kernels.refuse_grad`).
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


@functools.lru_cache(maxsize=None)
def _entries():
    lib = load_library("groupnorm_silu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    two_pass, cluster = lib.groupnorm_silu, lib.groupnorm_silu_cluster
    two_pass.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, f, i,
                         i, p]
    cluster.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, p]
    two_pass.restype = cluster.restype = ctypes.c_int
    return two_pass, cluster


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


def _launch(x, gamma, beta, scale, shift, num_groups, eps, act):
    global launches
    refuse_grad("fused_groupnorm_silu", x, gamma, beta, scale, shift)
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or fp32, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned "
                         "[B, H, W, C] tensor")
    b, h, w, c = x.shape
    vec = 16 // x.element_size()
    # at most 256 threads across C, so the stats pass's [2, rows, C] fp32
    # reduction buffer stays within 16 KB of shared memory
    if c % vec or c // vec > 256 or not 0 < b <= 65535:
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
              beta.data_ptr(), None if scale is None else scale.data_ptr(),
              None if shift is None else shift.data_ptr(), film_stride)
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
