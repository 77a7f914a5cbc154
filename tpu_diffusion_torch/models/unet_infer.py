"""Fused-inference UNet forward: the sampler-path twin of `UNetModel` that
sends its large ResBlocks through the whole-ResBlock kernel.

Counterpart of `tpu_diffusion/models/unet_infer.py` (`FusedUNetInference`,
`make_fused_apply`). Built once from a port `UNetModel`, it is called like
the model, `fn(x_nhwc, t, mode="full"|"encode"|"decode", cache=None)`, and
is a drop-in for the samplers. It walks the model's own forward
(`UNetModel.run`) with one change: a ResBlock over at least
`kernel_min_tokens` pixels goes to `kernels/resblock.py:fused_resblock`,
fed from weights repacked once at construction (the port's convs are OIHW,
the kernel takes the JAX package's HWIO). Smaller ResBlocks run the
model's own `ResBlock` module and attention the model's own
`AttentionBlock`. Activations are NHWC in memory (`channels_last`), so no
layout copy surrounds the kernel. Inference only: the weights are a
snapshot, and nothing here is differentiated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.kernels.resblock import fused_resblock
from tpu_diffusion_torch.models.nn import channels_last
from tpu_diffusion_torch.models.unet import ResBlock, UNetModel

RESBLOCK_IMPLS = ("kernel", "plain")


class FusedUNetInference:
    """`resblock="kernel"`: `fused_resblock` for every ResBlock of at least
    `kernel_min_tokens` pixels (0: all of them); a block the kernel does not
    take raises. `resblock="plain"`: the model's own ResBlocks everywhere.

    `res_decisions` maps each ResBlock's name to what its last call ran
    ("kernel" or "module"), with its pixel count and channels.
    """

    def __init__(self, model: UNetModel, *, resblock: str = "kernel",
                 kernel_min_tokens: int = 1024):
        if resblock not in RESBLOCK_IMPLS:
            raise ValueError(f"resblock must be one of {RESBLOCK_IMPLS}, got "
                             f"{resblock!r}")
        if model.resblock_updown:
            raise ValueError("resblock up/down is not supported by the "
                             "fused-inference engine")
        self.model = model
        self.resblock = resblock
        self.kernel_min_tokens = kernel_min_tokens
        self.res_decisions: dict = {}
        self.layout_copies = 0  # kernel inputs that were not NHWC in memory
        self.packed = {name: self._pack(m, model.dtype)
                       for name, m in model.named_children()
                       if isinstance(m, ResBlock)}

    @staticmethod
    @torch.no_grad()
    def _pack(block: ResBlock, dtype) -> dict:
        """The kernel's operands: conv kernels HWIO in the compute type,
        the 1x1 skip as [Cin, Cout], every vector fp32."""
        def hwio(conv):
            return conv.weight.to(dtype).permute(2, 3, 1, 0).contiguous()

        packed = dict(
            gn1_scale=block.in_norm.weight.float(),
            gn1_bias=block.in_norm.bias.float(),
            w1=hwio(block.in_conv), b1=block.in_conv.bias.float(),
            gn2_scale=block.out_norm.weight.float(),
            gn2_bias=block.out_norm.bias.float(),
            w2=hwio(block.out_conv), b2=block.out_conv.bias.float(),
            wskip=None, bskip=None)
        if block.skip is not None:
            packed["wskip"] = hwio(block.skip)[0, 0].contiguous()
            packed["bskip"] = block.skip.bias.float()
        return packed

    def _resblock(self, name: str, h: torch.Tensor, emb: torch.Tensor
                  ) -> torch.Tensor:
        block = getattr(self.model, name)
        tokens = h.shape[2] * h.shape[3]
        use_kernel = (self.resblock == "kernel"
                      and tokens >= self.kernel_min_tokens)
        self.res_decisions[name] = {
            "impl": "kernel" if use_kernel else "module", "tokens": tokens,
            "cin": h.shape[1], "cout": block.cout}
        if not use_kernel:
            return block(h, emb)
        p = self.packed[name]
        emb_out = block.emb_dense(F.silu(emb))
        if block.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            emb_scale, emb_shift = 1.0 + scale.float(), shift
        else:
            emb_scale, emb_shift = None, emb_out
        # NCHW in channels_last memory: the NHWC view is contiguous
        if not h.is_contiguous(memory_format=torch.channels_last):
            self.layout_copies += 1
            h = channels_last(h)
        out = fused_resblock(
            h.permute(0, 2, 3, 1), p["gn1_scale"], p["gn1_bias"], p["w1"],
            p["b1"], p["gn2_scale"], p["gn2_bias"], emb_scale, emb_shift,
            p["w2"], p["b2"], p["wskip"], p["bskip"])
        return out.permute(0, 3, 1, 2)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t, *, mode: str = "full",
                 cache=None):
        return self.model.run(x, t, mode, cache, self._resblock)


def make_fused_apply(model: UNetModel, *, resblock: str = "kernel",
                     kernel_min_tokens: int = 1024) -> FusedUNetInference:
    """model -> fn(x, t, mode=..., cache=...) matching `model(x, t, ...)`:
    a drop-in for the samplers."""
    return FusedUNetInference(model, resblock=resblock,
                              kernel_min_tokens=kernel_min_tokens)
