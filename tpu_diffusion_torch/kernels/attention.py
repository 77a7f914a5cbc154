"""Fused-QKV self-attention: the hand-written CUDA kernel and its plain version.

Counterpart of `tpu_diffusion/kernels/attention.py:flash_attention_fused`.
The input is the raw `[B, T, 3C]` qkv projection with channel order
`((s*heads + h)*d + i)` for s in {q, k, v}; the output is the merged
`[B, T, C]` context. A CPU tensor goes to `fused_attention_ref`; a CUDA
tensor goes to `csrc/attention_fused.cu` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by `flash_attention_fused` since the count was last
# set to 0 (callers reset it to check that a path went through the kernel).
launches = 0

HEAD_DIMS = (32, 64, 128)


def fused_attention_ref(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits and softmax, p cast to v's type."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    r = qkv.reshape(b, t, 3, heads, d)
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, c)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("attention_fused").attention_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fused(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head, from the raw [B, T, 3C] qkv."""
    if qkv.device.type == "cpu":
        return fused_attention_ref(qkv, heads)
    return _launch(qkv, heads)


def _launch(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    global launches
    if not qkv.is_cuda:
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qkv must be bf16 or fp32, got {qkv.dtype}")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, T, 3C], got {tuple(qkv.shape)}")
    b, t, c3 = qkv.shape
    c = c3 // 3
    if heads < 1 or c % heads or c // heads not in HEAD_DIMS:
        raise ValueError(f"C={c} with {heads} heads: head_dim must be one "
                         f"of {HEAD_DIMS}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if not (0 < b <= 65535 and heads <= 65535 and t > 0):
        raise ValueError(f"unsupported shape {tuple(qkv.shape)}")
    d = c // heads
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _entry()(qkv.data_ptr(), out.data_ptr(), b, t, heads, d,
                       d ** -0.5, int(qkv.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_fused launch failed: cudaError {err}")
    launches += 1
    return out
