"""FLOPs of the latent-diffusion UNet, counted on the plain reference
(`reference/ldm_unet.py`) on the meta device from a configuration's keys,
the way `counts/flops.py` counts the pixel UNet's: every Conv2d and Linear
product (2 multiply-adds per weight use) and each attention's two products,
4 B T S C for T queries against S keys (S = T in self-attention, the
context's length in cross-attention). Per image row: batch 1."""

from __future__ import annotations

import torch

from benchmark.reference.ldm_unet import Attention, Conv, LDMUNet, Linear

CONTEXT_TOKENS = 77


def forward_flops(cfg: dict, context_tokens: int = CONTEXT_TOKENS) -> int:
    """FLOPs of one row's forward at the configuration's `sample_size`."""
    with torch.device("meta"):
        model = LDMUNet(cfg)
    total = [0]

    def product(module, args, out):
        if isinstance(module, Conv):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * out.numel() * module.in_channels * k
        else:
            total[0] += 2 * out.numel() * module.in_features

    def attention(module, args, out):
        h, c = args
        total[0] += 4 * h.shape[0] * h.shape[1] * c.shape[1] * h.shape[2]

    handles = [m.register_forward_hook(product) for m in model.modules()
               if isinstance(m, (Conv, Linear))]
    handles += [m.register_forward_hook(attention) for m in model.modules()
                if isinstance(m, Attention)]
    side = cfg["sample_size"]
    x = torch.empty(1, side, side, cfg["in_channels"], device="meta")
    ctx = torch.empty(1, context_tokens, cfg["cross_attention_dim"],
                      device="meta")
    with torch.no_grad():
        model(x, torch.empty(1, device="meta"), ctx)
    for h in handles:
        h.remove()
    return total[0]
