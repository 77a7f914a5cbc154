"""GroupNorm(+FiLM)+SiLU: the hand-written CUDA kernel and its plain version.

Counterpart of `tpu_diffusion/kernels/groupnorm.py:fused_groupnorm_silu`:
`act(GN(x) * gamma * (1 + scale) + beta * (1 + scale) + shift)` with fp32
group statistics, on NHWC x. A CPU tensor goes to `reference_groupnorm_silu`;
a CUDA tensor goes to `csrc/groupnorm_silu.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by `fused_groupnorm_silu` since the count was last
# set to 0. One launch is the stats pass and the apply pass together.
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
def _entry():
    fn = load_library("groupnorm_silu").groupnorm_silu
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i, i, i,
                   ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


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
    """(rows, pixels per chunk, chunks) of the kernel's blocks: each block
    has (C / vec) * rows threads (vec elements per 16-byte load) and covers
    `pixels per chunk` pixels of one image, 4 per thread."""
    cv = c // (16 // itemsize)
    rows = max(1, 256 // cv)
    pix = rows * 4
    return rows, pix, -(-hw // pix)


def _launch(x, gamma, beta, scale, shift, num_groups, eps, act):
    global launches
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
    rows, pix, nchunk = launch_geometry(c, h * w, x.element_size())
    out = torch.empty_like(x)
    partials = torch.empty((b, nchunk, num_groups, 2), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), film_stride,
            partials.data_ptr(), b, h * w, c, num_groups, rows, pix, nchunk,
            eps, int(act == "silu"), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"groupnorm_silu launch failed: cudaError {err}")
    launches += 1
    return out
