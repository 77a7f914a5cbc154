"""Guided-diffusion style UNet in PyTorch.

Counterpart of `tpu_diffusion/models/unet.py` (`ResBlock`, `AttentionBlock`,
`Downsample`, `Upsample`, `UNetModel`, `create_model`, `attention_ds`, and
the torchcfm wrappers `UNetModelWrapper`, `InPaintModelWrapper` and
`SuperResModelWrapper`). With `sp_mesh`, attention shards its tokens over
the mesh's "model" ranks by ring attention (`parallel/sp.py`) where the
axis has more than one rank and divides the tokens; elsewhere the block's
own implementation runs. `use_checkpoint` recomputes each ResBlock's
activations in the backward pass (the JAX `nn.remat`).
The public layout is the JAX package's: `model(x_nhwc, t)` returns NHWC
eps, and the encode/decode cache holds NHWC tensors. Internally activations
are NCHW in `channels_last` memory (see `models/nn.py`). Submodules carry
the flax module names (`enc_0_0`, `mid_attn`, `dec_attn_1_2`, ...), so
`convert.py` maps one tree onto the other by name. As in the JAX package
(flax `param_dtype`), every parameter is fp32 and the convs and dense
layers cast theirs to `dtype` at use (`models/nn.py:CastConv2d`), so the
optimizer updates fp32 values whatever the forward's type.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_diffusion_torch.conditioning.likelihoods import resize_bilinear
from tpu_diffusion_torch.kernels.attention import (dense_attention,
                                                   flash_attention,
                                                   flash_attention_fused)
from tpu_diffusion_torch.models.nn import (NORM_IMPLS, CastConv2d,
                                           CastEmbedding, CastLinear,
                                           FusedNormAct,
                                           GroupNorm32, avg_pool_2x,
                                           channels_last, dropout,
                                           dropout_keep,
                                           nearest_upsample,
                                           timestep_embedding, zero_init_conv)
from tpu_diffusion_torch.parallel.sp import maybe_sequence_parallel

# "fused": the fused-QKV kernel (JAX "pallas_fused"); "flash": split heads
# and the flash kernels (JAX "pallas"); "dense": the layout-preserving
# einsums in plain torch (JAX "xla"); "auto": flash at FLASH_MIN_TOKENS
# tokens or more, dense below, on every device.
ATTENTION_IMPLS = ("fused", "flash", "dense", "auto")
FLASH_MIN_TOKENS = 1024
MODES = ("full", "encode", "decode")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device that is not there
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


class SameConv2d(CastConv2d):
    """Conv2d with flax's "SAME" padding, which for a strided conv puts the
    odd padding row and column at the end (bottom/right)."""

    def __init__(self, cin, cout, kernel_size, stride=1, **kw):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=0,
                         **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                           reversed(self.stride)):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def conv3x3(cin: int, cout: int, dtype, device) -> CastConv2d:
    return CastConv2d(cin, cout, 3, padding=1, dtype=dtype, device=device)


def make_norm(channels: int, norm_impl: str, norm_dtype, device,
              act: str = "silu") -> nn.Module:
    if norm_impl == "fused":
        return FusedNormAct(channels, act=act, device=device)
    return GroupNorm32(channels, dtype=norm_dtype, device=device)


class ResBlock(nn.Module):
    """Residual block with FiLM (scale-shift) or additive time conditioning."""

    def __init__(self, cin: int, cout: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False,
                 down: bool = False, dtype=torch.bfloat16, norm_dtype=None,
                 norm_impl: str = "plain", device=None,
                 dropout: float = 0.0):
        super().__init__()
        self.cout = cout
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.fused = norm_impl == "fused"
        self.in_norm = make_norm(cin, norm_impl, norm_dtype, device)
        self.in_conv = conv3x3(cin, cout, dtype, device)
        self.emb_dense = CastLinear(
            emb_dim, 2 * cout if use_scale_shift_norm else cout, dtype=dtype,
            device=device)
        self.out_norm = make_norm(cout, norm_impl, norm_dtype, device)
        self.out_conv = zero_init_conv(conv3x3(cout, cout, dtype, device))
        self.skip = (CastConv2d(cin, cout, 1, dtype=dtype, device=device)
                     if cin != cout else None)

    def dropout_keep(self, x: torch.Tensor,
                     generator: torch.Generator | None
                     ) -> torch.Tensor | None:
        """The dropout mask that `forward(x, ...)` would draw from
        `generator`, drawn now; None where it draws none."""
        if not (self.training and self.dropout > 0):
            return None
        b, _, h, w = x.shape
        if self.up:
            h, w = 2 * h, 2 * w
        elif self.down:
            h, w = h // 2, w // 2
        return dropout_keep((b, self.cout, h, w), self.dropout, generator,
                            x.device)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """`generator` draws the dropout mask (in `train()` mode only),
        unless `keep` (`dropout_keep`) hands it in."""
        h = self.in_norm(x) if self.fused else F.silu(self.in_norm(x))
        if self.up:
            h, x = nearest_upsample(h), nearest_upsample(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_conv(h)
        emb_out = self.emb_dense(F.silu(emb))
        if self.use_scale_shift_norm:
            if self.fused:
                h = self.out_norm(h, film=emb_out)
            else:
                scale = emb_out[:, :self.cout, None, None]
                shift = emb_out[:, self.cout:, None, None]
                h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = h + emb_out[:, :, None, None]
            h = self.out_norm(h) if self.fused else F.silu(self.out_norm(h))
        if self.training and self.dropout > 0:
            h = dropout(h, self.dropout, generator, keep)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


def checkpointed(block: ResBlock, h: torch.Tensor, emb: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
    """`block(h, emb, generator)` under `torch.utils.checkpoint`: its
    activations are recomputed in the backward pass. Its dropout mask is
    drawn first, as the block would draw it, and handed to the forward and
    to the recomputation, which so draws nothing: no generator state is
    saved or restored, inside a CUDA graph capture or out of it."""
    keep = block.dropout_keep(h, generator)
    return checkpoint(block, h, emb, None, keep, use_reentrant=False,
                      preserve_rng_state=False)


class AttentionBlock(nn.Module):
    """Self-attention over the H*W tokens of each image. `last_impl` names
    the implementation of the last call ("ring" where the tokens were
    sharded over `sp_mesh`)."""

    def __init__(self, channels: int, num_heads: int = 1,
                 num_head_channels: int = -1, impl: str = "fused",
                 dtype=torch.bfloat16, norm_dtype=None,
                 norm_impl: str = "plain", device=None, sp_mesh=None):
        super().__init__()
        if num_head_channels > 0 and channels % num_head_channels:
            raise ValueError(f"channels {channels} not divisible by "
                             f"num_head_channels={num_head_channels}")
        self.heads = (channels // num_head_channels if num_head_channels > 0
                      else num_heads)
        if channels % self.heads:
            raise ValueError(
                f"channels {channels} not divisible by {self.heads} heads")
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention impl must be one of "
                             f"{ATTENTION_IMPLS}, got {impl!r}")
        self.impl = impl
        self.sp_mesh = sp_mesh
        self.last_impl = None
        self.norm = make_norm(channels, norm_impl, norm_dtype, device,
                              act="none")
        self.qkv = CastLinear(channels, 3 * channels, dtype=dtype,
                              device=device)
        self.proj = zero_init_conv(CastLinear(channels, channels,
                                              dtype=dtype, device=device))

    def resolved_impl(self, tokens: int) -> str:
        """The implementation a call over `tokens` tokens runs."""
        if self.impl == "auto":
            return "flash" if tokens >= FLASH_MIN_TOKENS else "dense"
        return self.impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        qkv = self.qkv(y)  # [b, T, 3c], channel ((s*heads + h)*d + i)
        impl = self.resolved_impl(h * w)
        out = None
        if self.sp_mesh is not None or impl == "flash":
            # [b, heads, T, d] views
            q, k, v = qkv.reshape(b, h * w, 3, self.heads, c // self.heads
                                  ).permute(2, 0, 3, 1, 4).unbind(0)
        if self.sp_mesh is not None:
            out = maybe_sequence_parallel(q, k, v, self.sp_mesh)
        if out is not None:
            impl = "ring"
            out = out.transpose(1, 2).reshape(b, h * w, c)
        elif impl == "fused":
            out = flash_attention_fused(qkv, self.heads)
        elif impl == "flash":
            out = flash_attention(q, k, v).transpose(1, 2).reshape(
                b, h * w, c)
        else:
            out = dense_attention(qkv, self.heads)
        self.last_impl = impl
        out = self.proj(out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv = SameConv2d(cin, cout, 3, stride=2, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv = conv3x3(cin, cout, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample(x))


class UNetModel(nn.Module):
    """The denoiser backbone: model(x_nhwc, t[, y]) -> [B, H, W,
    out_channels]. With `num_classes`, the labels `y` ([B] integers) are
    embedded (`class_emb`) and added to the time embedding.

    `attn_decisions` maps each attention block's name to the implementation
    it ran, its token count and head count, as of its last call. The
    timestep is embedded as `t * time_scale` (1000 for the CFM wrappers,
    whose t is in [0, 1]). `use_checkpoint` recomputes every ResBlock in
    the backward pass when training; `sp_mesh` is handed to every
    attention block.
    """

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int = 2,
                 attention_resolutions: Tuple[int, ...] = (),
                 channel_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 num_heads: int = 1,
                 num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 attention_impl: str = "fused", dtype=torch.bfloat16,
                 norm_dtype=None, norm_impl: str = "plain", device="cuda",
                 dropout: float = 0.0, time_scale: float = 1.0,
                 num_classes: int | None = None,
                 use_checkpoint: bool = False, sp_mesh=None):
        super().__init__()
        if norm_impl not in NORM_IMPLS:
            raise ValueError(f"norm_impl must be one of {NORM_IMPLS}, got "
                             f"{norm_impl!r}")
        device = resolve_device(device)
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.resblock_updown = resblock_updown
        self.dtype = dtype
        self.time_scale = time_scale
        self.use_checkpoint = use_checkpoint
        self.sp_mesh = sp_mesh
        self.attn_decisions: dict = {}
        ch0 = model_channels
        time_dim = 4 * ch0
        dd = dict(dtype=dtype, device=device)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlock(
                cin, cout, time_dim, use_scale_shift_norm, dtype=dtype,
                norm_dtype=norm_dtype, norm_impl=norm_impl, device=device,
                dropout=dropout, **kw))

        def attn(name, ch):
            self.add_module(name, AttentionBlock(
                ch, num_heads, num_head_channels, attention_impl, dtype,
                norm_dtype, norm_impl, device, sp_mesh))

        self.time_dense_0 = CastLinear(ch0, time_dim, **dd)
        self.time_dense_1 = CastLinear(time_dim, time_dim, **dd)
        self.class_emb = (None if num_classes is None else
                          CastEmbedding(num_classes, time_dim, **dd))
        self.conv_in = conv3x3(in_channels, ch0, dtype, device)
        chans = [ch0]
        ch, ds = ch0, 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                res(f"enc_{level}_{i}", ch, mult * ch0)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    attn(f"enc_attn_{level}_{i}", ch)
                chans.append(ch)
            if level != len(self.channel_mult) - 1:
                if resblock_updown:
                    res(f"down_{level}", ch, ch, down=True)
                else:
                    self.add_module(f"down_{level}", Downsample(ch, ch,
                                                                **dd))
                chans.append(ch)
                ds *= 2
        mid = self.channel_mult[-1] * ch0
        res("mid_res_0", ch, mid)
        attn("mid_attn", mid)
        res("mid_res_1", mid, mid)
        ch = mid
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                res(f"dec_{level}_{i}", ch + chans.pop(), mult * ch0)
                ch = mult * ch0
                if ds in self.attention_resolutions:
                    attn(f"dec_attn_{level}_{i}", ch)
                if level and i == num_res_blocks:
                    if resblock_updown:
                        res(f"up_{level}", ch, ch, up=True)
                    else:
                        self.add_module(f"up_{level}", Upsample(ch, ch,
                                                                **dd))
                    ds //= 2
        self.out_norm = make_norm(ch, norm_impl, norm_dtype, device)
        self.fused_out_norm = norm_impl == "fused"
        self.conv_out = zero_init_conv(
            conv3x3(ch, out_channels, torch.float32, device))

    def _attn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        out = block(h)
        self.attn_decisions[name] = {"impl": block.last_impl,
                                     "tokens": h.shape[2] * h.shape[3],
                                     "heads": block.heads}
        return out

    def forward(self, x: torch.Tensor, t, y: torch.Tensor | None = None, *,
                mode: str = "full", cache=None,
                generator: torch.Generator | None = None):
        """mode="full": the plain forward. mode="encode": the
        `(bottleneck, skips)` cache (NHWC). mode="decode": middle and
        decoder from such a cache, with the current timestep's embedding.
        `generator` draws the dropout masks in `train()` mode."""
        def res_fn(name, h, emb):
            block = getattr(self, name)
            if (self.use_checkpoint and self.training
                    and torch.is_grad_enabled()):
                return checkpointed(block, h, emb, generator)
            return block(h, emb, generator)

        return self.run(x, t, mode, cache, res_fn, y)

    def run(self, x: torch.Tensor, t, mode: str, cache, res_fn, y=None):
        """The forward with every ResBlock called as `res_fn(name, h, emb)`
        (`models/unet_infer.py` passes its own)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        ch0 = self.model_channels
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        t = torch.broadcast_to(t, (x.shape[0],))
        emb = timestep_embedding(t * self.time_scale, ch0)
        emb = self.time_dense_0(emb.to(self.dtype))
        emb = self.time_dense_1(F.silu(emb))
        if self.class_emb is not None:
            if y is None:
                raise ValueError("class-conditional model requires labels")
            emb = emb + self.class_emb(y)

        if mode in ("full", "encode"):
            h = self.conv_in(x.permute(0, 3, 1, 2).to(self.dtype))
            hs = [h]
            ds = 1
            for level, _ in enumerate(self.channel_mult):
                for i in range(self.num_res_blocks):
                    h = res_fn(f"enc_{level}_{i}", h, emb)
                    if ds in self.attention_resolutions:
                        h = self._attn(f"enc_attn_{level}_{i}", h)
                    hs.append(h)
                if level != len(self.channel_mult) - 1:
                    h = (res_fn(f"down_{level}", h, emb)
                         if self.resblock_updown
                         else getattr(self, f"down_{level}")(h))
                    hs.append(h)
                    ds *= 2
            if mode == "encode":
                return (h.permute(0, 2, 3, 1),
                        tuple(s.permute(0, 2, 3, 1) for s in hs))
        else:
            if cache is None:
                raise ValueError("mode='decode' requires cache")
            h = cache[0].permute(0, 3, 1, 2)
            hs = [s.permute(0, 3, 1, 2) for s in cache[1]]
            ds = 2 ** (len(self.channel_mult) - 1)

        h = res_fn("mid_res_0", h, emb)
        h = self._attn("mid_attn", h)
        h = res_fn("mid_res_1", h, emb)
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = channels_last(torch.cat([h, hs.pop()], dim=1))
                h = res_fn(f"dec_{level}_{i}", h, emb)
                if ds in self.attention_resolutions:
                    h = self._attn(f"dec_attn_{level}_{i}", h)
                if level and i == self.num_res_blocks:
                    h = (res_fn(f"up_{level}", h, emb)
                         if self.resblock_updown
                         else getattr(self, f"up_{level}")(h))
                    ds //= 2
        if hs:
            raise RuntimeError(f"{len(hs)} skip tensors left unused")
        h = (self.out_norm(h) if self.fused_out_norm
             else F.silu(self.out_norm(h)))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


_DEFAULT_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
    28: (1, 2, 2),
}


def attention_ds(image_size: int, attention_resolutions: str | Sequence[int]
                 ) -> Tuple[int, ...]:
    """Parse "16,8"-style resolution strings into downsample rates."""
    if isinstance(attention_resolutions, str):
        if not attention_resolutions:
            return ()
        resolutions = [int(r) for r in attention_resolutions.split(",")]
    else:
        resolutions = list(attention_resolutions)
    return tuple(image_size // r for r in resolutions)


def create_model(image_size: int, num_channels: int, num_res_blocks: int,
                 in_channels: int = 3, out_channels: int | None = None,
                 channel_mult: Sequence[int] | str = "", num_heads: int = 1,
                 num_head_channels: int = -1,
                 attention_resolutions: str = "16,8",
                 dropout: float = 0.0, class_cond: bool = False,
                 num_classes: int | None = None,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 use_checkpoint: bool = False, learn_sigma: bool = False,
                 attention_impl: str = "fused", dtype=torch.bfloat16,
                 norm_dtype=None, norm_impl: str = "plain",
                 device="cuda", sp_mesh=None,
                 time_scale: float = 1.0) -> UNetModel:
    """The JAX `create_model` signature, plus `device`."""
    if not channel_mult:
        if image_size not in _DEFAULT_CHANNEL_MULT:
            raise ValueError(f"unsupported image size: {image_size}")
        channel_mult = _DEFAULT_CHANNEL_MULT[image_size]
    elif isinstance(channel_mult, str):
        channel_mult = tuple(int(c) for c in channel_mult.split(","))
    return UNetModel(
        in_channels=in_channels, model_channels=num_channels,
        out_channels=out_channels or (2 * in_channels if learn_sigma
                                      else in_channels),
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds(image_size, attention_resolutions),
        channel_mult=tuple(channel_mult), num_heads=num_heads,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown, attention_impl=attention_impl,
        dtype=dtype, norm_dtype=norm_dtype, norm_impl=norm_impl,
        device=device, dropout=dropout, time_scale=time_scale,
        num_classes=num_classes if class_cond else None,
        use_checkpoint=use_checkpoint, sp_mesh=sp_mesh)


# ---------------------------------------------------------------------------
# torchcfm-style wrappers
# ---------------------------------------------------------------------------


def _cfm_backbone(dim: Tuple[int, int, int], num_channels: int,
                  in_channels: int, num_res_blocks: int = 2,
                  channel_mult=None, num_heads: int = 4,
                  attention_resolutions: str = "16", dropout: float = 0.0,
                  num_classes: int | None = None,
                  attention_impl: str = "dense", dtype=torch.bfloat16,
                  device="cuda", sp_mesh=None) -> UNetModel:
    h, w, c = dim
    return create_model(
        image_size=h, num_channels=num_channels,
        num_res_blocks=num_res_blocks, in_channels=in_channels,
        out_channels=c, channel_mult=channel_mult or "",
        num_heads=num_heads, attention_resolutions=attention_resolutions,
        dropout=dropout, class_cond=num_classes is not None,
        num_classes=num_classes, use_scale_shift_norm=True,
        attention_impl=attention_impl, dtype=dtype, device=device,
        sp_mesh=sp_mesh, time_scale=1000.0)  # torchcfm embeds t * 1000


class UNetModelWrapper(nn.Module):
    """torchcfm `UNetModelWrapper`: the velocity field v(t, x[, y]) -> NHWC.

    `dim` is (H, W, C), NHWC as in the JAX package. The backbone (`net`,
    so the JAX tree's `net/` prefix maps by name) has FiLM, embeds
    t * 1000, computes in `dtype` with fp32 parameters. `attention_impl`
    takes the port's names ("dense" is the JAX default "xla"; "auto" is
    dense below 1024 tokens). With `num_classes`, `y` is required.
    `sp_mesh` reaches every attention block."""

    def __init__(self, dim: Tuple[int, int, int], num_channels: int = 128,
                 num_res_blocks: int = 2, channel_mult=None,
                 num_heads: int = 4, attention_resolutions: str = "16",
                 dropout: float = 0.0, num_classes: int | None = None,
                 attention_impl: str = "dense", dtype=torch.bfloat16,
                 device="cuda", sp_mesh=None):
        super().__init__()
        self.net = _cfm_backbone(dim, num_channels, dim[2], num_res_blocks,
                                 channel_mult, num_heads,
                                 attention_resolutions, dropout, num_classes,
                                 attention_impl, dtype, device, sp_mesh)

    def forward(self, t, x: torch.Tensor, y: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`generator` draws the dropout masks in `train()` mode."""
        return self.net(x, t, y, generator=generator)


class _ConcatWrapper(nn.Module):
    """A CFM backbone over 2C channels: x and a condition image of x's
    shape, concatenated on the channel axis."""

    def __init__(self, dim: Tuple[int, int, int], num_channels: int,
                 num_res_blocks: int = 2, channel_mult=None,
                 num_heads: int = 4, attention_resolutions: str = "16",
                 dropout: float = 0.0, attention_impl: str = "dense",
                 dtype=torch.bfloat16, device="cuda", sp_mesh=None):
        super().__init__()
        self.net = _cfm_backbone(dim, num_channels, 2 * dim[2],
                                 num_res_blocks, channel_mult, num_heads,
                                 attention_resolutions, dropout, None,
                                 attention_impl, dtype, device, sp_mesh)

    def _concat(self, t, x, cond, generator):
        return self.net(torch.cat([x, cond], dim=-1), t, generator=generator)


class InPaintModelWrapper(_ConcatWrapper):
    """torchcfm `InPaintModelWrapper`: v(t, x, con), the masked image `con`
    concatenated as extra input channels (mnist/train_mnist.py:193)."""

    def __init__(self, dim: Tuple[int, int, int], num_channels: int = 32,
                 **kw):
        super().__init__(dim, num_channels, **kw)

    def forward(self, t, x: torch.Tensor, con: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self._concat(t, x, con, generator)


class SuperResModelWrapper(_ConcatWrapper):
    """torchcfm `SuperResModelWrapper`: v(t, x, low_res), the low-res image
    resized bilinearly to x's size (when the sizes differ) riding along as
    extra channels (mnist/train_mnist_hy.py:231)."""

    def __init__(self, dim: Tuple[int, int, int], num_channels: int = 128,
                 **kw):
        super().__init__(dim, num_channels, **kw)

    def forward(self, t, x: torch.Tensor, low_res: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h, w = x.shape[1:3]
        if tuple(low_res.shape[1:3]) != (h, w):
            low_res = resize_bilinear(low_res, h, w)
        return self._concat(t, x, low_res, generator)


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from `generator` (a CPU generator, so a seed
    gives the same weights on every device): weights ~ N(0, 1/fan_in),
    biases ~ N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), norm biases
    N(0, 0.1^2). The zero-initialised output convs are drawn like any
    other, so eps is not identically 0."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, (GroupNorm32, FusedNormAct)):
                v = torch.randn(p.shape, generator=generator) * 0.1
                if name == "weight":
                    v += 1.0
            elif name == "weight":
                fan_in = p[0].numel()
                v = torch.randn(p.shape, generator=generator) / fan_in ** 0.5
            else:
                v = torch.randn(p.shape, generator=generator) * 0.02
            p.copy_(v)
    return model
