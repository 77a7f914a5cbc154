"""Self-attention kernels: the hand-written CUDA kernels and their plain versions.

Counterparts of `tpu_diffusion/kernels/attention.py`:

- `flash_attention_fused` (`_fused_kernel_call`): from the raw `[B, T, 3C]`
  qkv projection with channel order `((s*heads + h)*d + i)` for s in
  {q, k, v} to the merged `[B, T, C]` context. Plain version
  `dense_attention`, kernel `csrc/attention_fused.cu`.
- `flash_attention` (the JAX custom-VJP `flash_attention`): a
  `torch.autograd.Function` on `[B, H, T, d]` or `[BH, T, d]` whose forward
  is `flash_attention_fwd` (`_flash_attention_3d`: o and the fp32 row
  logsumexp) and whose backward is `flash_attention_bwd`
  (`_flash_attention_bwd_3d`: dq, dk, dv recomputed from the lse). Plain
  versions `flash_attention_fwd_ref` / `flash_attention_bwd_ref`, kernels
  `csrc/flash_attention.cu`; `flash_fwd_route` picks the forward's kernel.
- `flash_cross_attention` (no JAX counterpart: the latent-diffusion UNet's
  cross-attention, `models/ldm_unet.py`): queries [BH, Tq, d] against a
  short key set [BH, Tk, d], Tk <= XATTN_MAX_KEYS, forward only. Plain
  version `flash_attention_fwd_ref`, kernel `flash_xattn_fwd_kernel` in
  `csrc/flash_attention.cu`.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_diffusion_torch.kernels import refuse_grad
from tpu_diffusion_torch.kernels.build import load_library

# Kernel launches made by each wrapper since its count was last set to 0
# (callers reset them to check that a path went through the kernels):
# `flash_attention_fused`, `flash_attention_fwd`, and `flash_attention_bwd`
# (one count per call, whatever number of CUDA kernels stands behind it).
launches = 0
flash_fwd_launches = 0
flash_bwd_launches = 0
flash_xattn_launches = 0

HEAD_DIMS = (32, 64, 128)


def dense_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch attention from the raw [B, T, 3C] qkv to [B, T, C]: the
    JAX "xla" path (`tpu_diffusion/models/unet.py:187-202`), with heads
    kept in the trailing axes, q * d^-1/2 in the model's type, fp32 logits
    and softmax, and probabilities cast to v's type. It is the UNet's
    "dense" attention and the plain version of `flash_attention_fused`."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    r = qkv.reshape(b, t, 3, heads, d)
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * d ** -0.5).float(),
                          k.float())
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
    """softmax(q k^T / sqrt(d)) v per head, from the raw [B, T, 3C] qkv.
    Differentiable: on the card through `_FusedAttention`."""
    if qkv.device.type == "cpu":
        return dense_attention(qkv, heads)
    return _FusedAttention.apply(qkv, heads)


class _FusedAttention(torch.autograd.Function):
    """The JAX `flash_attention_fused` custom VJP (`_faf_fwd`, `_faf_bwd`):
    the kernel forward, and as the backward the vjp of the plain version
    recomputed from the saved qkv. The JAX package has no backward kernel
    for it either."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _launch(qkv, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_()
            out = dense_attention(x, ctx.heads)
        dqkv, = torch.autograd.grad(out, x, g.to(out.dtype))
        return dqkv.to(qkv.dtype), None


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


# ---------------------------------------------------------------------------
# Flash attention on [BH, T, d]
# ---------------------------------------------------------------------------


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor):
    """Plain version of the forward (`reference_attention` plus the lse):
    fp32 logits of q * d^-1/2 against k, p normalised and rounded to v's
    type, p.v accumulated in fp32. Returns (o in q's type, lse fp32)."""
    d = q.shape[-1]
    logits = torch.einsum("...td,...sd->...ts", q.float() * d ** -0.5,
                          k.float())
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("...ts,...sd->...td", p.float(), v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, g, lse, delta):
    """Plain version of the backward, by the kernels' recompute formulas
    (not autograd of the forward): p = exp(q d^-1/2 k^T - lse) in fp32,
    ds = p (g v^T - delta), dq = ds k d^-1/2, dv = p^T g, dk = ds^T q d^-1/2.
    Returns (dq, dk, dv) in the inputs' type."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.exp(torch.einsum("...td,...sd->...ts", qf * scale, kf)
                  - lse[..., None])
    dp = torch.einsum("...td,...sd->...ts", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("...ts,...sd->...td", ds, kf) * scale
    dv = torch.einsum("...ts,...td->...sd", p, gf)
    dk = torch.einsum("...ts,...td->...sd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _flash_entries():
    lib = load_library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = lib.flash_attention_fwd, lib.flash_attention_bwd
    xattn = lib.flash_cross_attention_fwd
    fwd.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
    bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, i,
                    p]
    xattn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
    fwd.restype = bwd.restype = xattn.restype = ctypes.c_int
    return fwd, bwd, xattn


def _check_flash(name: str, ref: torch.Tensor, **tensors) -> None:
    """Raise unless ref is a [BH, T, d] bf16 or fp32 CUDA tensor (d in
    HEAD_DIMS, BH <= 65535) and every tensor is a contiguous, 16-byte
    aligned tensor with ref's shape, type and device."""
    if ref.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: inputs must be bf16 or fp32, got "
                         f"{ref.dtype}")
    if ref.ndim != 3 or ref.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: inputs must be [BH, T, d] with head_dim "
                         f"in {HEAD_DIMS}, got {tuple(ref.shape)}")
    bh, t, _ = ref.shape
    if not (0 < bh <= 65535 and t > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(ref.shape)}")
    if not ref.is_cuda:
        raise ValueError(f"{name}: inputs must be CUDA tensors, got "
                         f"{ref.device}")
    for key, x in tensors.items():
        if (x.device != ref.device or x.dtype != ref.dtype
                or x.shape != ref.shape):
            raise ValueError(f"{name}: {key} must match q's shape, type and "
                             f"device, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte "
                             f"aligned")


# The CUDA forward's routes, in the order of the C entry point's `route`.
FWD_ROUTES = ("scalar", "mma", "wgmma")
WGMMA_ROWS = 128  # query rows per block, and keys per tile, of the wgmma route


def flash_fwd_route(bh: int, t: int, d: int, dtype: torch.dtype) -> str:
    """The forward kernel that runs a [bh, t, d] call on the card: "wgmma"
    (bf16, d = 64, T a multiple of 128: warp-specialised, TMA and `wgmma`),
    "mma" (other bf16 shapes: `mma.sync`) or "scalar" (fp32). The C entry
    point refuses a "wgmma" launch for any other shape."""
    if dtype != torch.bfloat16:
        return "scalar"
    if d == 64 and t % WGMMA_ROWS == 0 and bh * t < 2 ** 31:
        return "wgmma"
    return "mma"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, lse) of softmax(q d^-1/2 k^T) v on [BH, T, d]; lse is fp32
    [BH, T]."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v)
    global flash_fwd_launches
    _check_flash("flash_attention_fwd", q, q=q, k=k, v=v)
    bh, t, d = q.shape
    route = FWD_ROUTES.index(flash_fwd_route(bh, t, d, q.dtype))
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _flash_entries()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, d, d ** -0.5, route,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{err}")
    flash_fwd_launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, g, lse, delta):
    """(dq, dk, dv) of the flash forward on [BH, T, d], from the upstream
    gradient g, the forward's lse and delta = rowsum(g * o) (both fp32
    [BH, T])."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, g, lse, delta)
    global flash_bwd_launches
    _check_flash("flash_attention_bwd", q, q=q, k=k, v=v, g=g)
    bh, t, d = q.shape
    for key, x in (("lse", lse), ("delta", delta)):
        if (x.device != q.device or x.dtype != torch.float32
                or x.shape != (bh, t) or not x.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {key} must be a "
                             f"contiguous fp32 [BH, T] tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernel sums dq over its key blocks into this fp32 scratch
    # with atomics (the order, and so dq's last bits, vary from run to run)
    dq_acc = (torch.zeros((bh, -(-t // 64) * 64, d), dtype=torch.float32,
                          device=q.device) if bf16 else None)
    with torch.cuda.device(q.device):
        err = _flash_entries()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr() if bf16 else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t, d, d ** -0.5, int(bf16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{err}")
    flash_bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX `flash_attention` custom VJP on [BH, T, d]."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(g * o) in fp32, outside the kernels as in the JAX
        # package (`_fa_bwd`)
        delta = (g.float() * o.float()).sum(dim=-1)
        return flash_attention_bwd(q, k, v, g.contiguous(), lse, delta)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q d^-1/2 k^T) v with flash forward and backward kernels.
    q, k, v: [B, H, T, d] or [BH, T, d]."""
    if q.ndim == 4:
        b, h, t, d = q.shape
        # one head's strided view reshapes without a copy: the kernels take
        # contiguous [BH, T, d] tensors
        o = _FlashAttention.apply(*(x.reshape(b * h, t, d).contiguous()
                                    for x in (q, k, v)))
        return o.reshape(b, h, t, d)
    return _FlashAttention.apply(q, k, v)


# ---------------------------------------------------------------------------
# Cross-attention: many queries against a short key set, forward only
# ---------------------------------------------------------------------------

XATTN_HEAD_DIM = 64
XATTN_MAX_KEYS = 128  # the whole key set is one tile in shared memory


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(q d^-1/2 k^T) v for q [BH, Tq, d] and k, v [BH, Tk, d]. On
    the card: bf16, d = 64, Tk <= XATTN_MAX_KEYS, no gradient (it raises
    where an input needs one); on the CPU the plain version, any shape."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v)[0]
    global flash_xattn_launches
    refuse_grad("flash_cross_attention", q, k, v)
    if q.dtype != torch.bfloat16 or q.ndim != 3 or \
            q.shape[-1] != XATTN_HEAD_DIM:
        raise ValueError(f"flash_cross_attention: q must be a bf16 [BH, Tq, "
                         f"{XATTN_HEAD_DIM}] tensor, got {tuple(q.shape)} "
                         f"{q.dtype}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if not (0 < bh <= 65535 and tq > 0 and 0 < tk <= XATTN_MAX_KEYS):
        raise ValueError(f"flash_cross_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)} (at most "
                         f"{XATTN_MAX_KEYS} keys)")
    if not q.is_cuda:
        raise ValueError(f"flash_cross_attention: inputs must be CUDA "
                         f"tensors, got {q.device}")
    for key, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or (
                key != "q" and x.shape != (bh, tk, d)):
            raise ValueError(f"flash_cross_attention: {key} must be a "
                             f"[{bh}, {tk}, {d}] {q.dtype} tensor on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_cross_attention: {key} must be "
                             f"contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _flash_entries()[2](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, tq,
            tk, d, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_cross_attention launch failed: cudaError "
                           f"{err}")
    flash_xattn_launches += 1
    return o
