"""FLOPs of FLUX.1 Fill [dev]'s transformer, counted on the plain reference
(`reference/flux.py`) on the meta device from a configuration's keys, the
way `counts/ldm_flops.py` counts the SD2 UNet's: every linear product (2
multiply-adds per weight use) and each joint attention's two products,
4 B H T S d for T queries against S keys (T = S: text and image tokens
together). One row, one call of the model: a sampling step."""

from __future__ import annotations

import torch

from benchmark.reference.flux import Attend, Flux, Linear


def forward_flops(cfg: dict, text_tokens: int, h: int, w: int) -> int:
    """FLOPs of one row's forward on an h x w grid of image tokens and
    `text_tokens` text tokens."""
    with torch.device("meta"):
        model = Flux(cfg)
    total = [0]

    def product(module, args, out):
        total[0] += 2 * out.numel() * module.in_features

    def attention(module, args, out):
        q, k, _ = args
        total[0] += 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] \
            * q.shape[3]

    handles = [m.register_forward_hook(product) for m in model.modules()
               if isinstance(m, Linear)]
    handles += [m.register_forward_hook(attention) for m in model.modules()
                if isinstance(m, Attend)]
    x = torch.empty(1, h * w, cfg["in_channels"], device="meta")
    ctx = torch.empty(1, text_tokens, cfg["joint_attention_dim"],
                      device="meta")
    pooled = torch.empty(1, cfg["pooled_projection_dim"], device="meta")
    with torch.no_grad():
        model(x, 1.0, 1.0, ctx, pooled, (h, w))
    for handle in handles:
        handle.remove()
    return total[0]
