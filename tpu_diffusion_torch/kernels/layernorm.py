"""LayerNorm over the last axis with fp32 statistics: the hand-written CUDA
kernel and its plain version.

No TPU counterpart: the JAX package runs no latent-diffusion UNet. Added
for the Stable Diffusion 2 UNet's transformer blocks
(`models/ldm_unet.py:LayerNorm32`, 48 calls a step), whose plain version
`layer_norm_ref` is three kernels on the card (a cast to fp32, the fp32
LayerNorm, a cast back: 20 bytes an element). `csrc/layernorm.cu` reads x
once and writes y once (4 bytes an element in bf16), with the statistics,
the weight and the bias in fp32 and one rounding, at the store.

A CPU tensor goes to `layer_norm_ref`; a CUDA tensor goes to the kernel or
raises: contiguous bf16 or fp32 x with C = x.shape[-1] a multiple of 8 up
to MAX_CHANNELS, contiguous fp32 weight and bias [C], all 16-byte
aligned, and no gradient (it raises where an input needs one).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.kernels import refuse_grad
from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by `layer_norm` since the count was last set to 0.
launches = 0

MAX_CHANNELS = 2048  # a row in one warp's registers
DTYPES = (torch.bfloat16, torch.float32)


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis in fp32 with the fp32
    weight and bias, the result in x's type."""
    return F.layer_norm(x.float(), weight.shape, weight, bias,
                        eps).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("layernorm").layer_norm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of x over its last axis of C channels, weight and bias
    [C]: on the card the kernel, on the CPU `layer_norm_ref`."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    global launches
    refuse_grad("layer_norm", x, weight, bias)
    c = x.shape[-1] if x.ndim else 0
    if x.dtype not in DTYPES or not 0 < c <= MAX_CHANNELS or c % 8:
        raise ValueError(f"layer_norm: x must be bf16 or fp32 with a last "
                         f"axis a multiple of 8 up to {MAX_CHANNELS}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_cuda or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm: x must be a contiguous, 16-byte "
                         f"aligned CUDA tensor, got {x.device}")
    for key, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (c,) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"layer_norm: {key} must be a contiguous, "
                             f"16-byte aligned fp32 [{c}] tensor on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype}")
    y = torch.empty_like(x)
    if not x.numel():
        return y
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       y.data_ptr(), x.numel() // c, c, eps,
                       int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm launch failed: cudaError {err}")
    launches += 1
    return y
