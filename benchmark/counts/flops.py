"""FLOPs of the UNet, counted on the plain reference model on the meta
device from a configuration's sizes: every Conv2d and Linear product
(2 multiply-adds per weight use) and each attention block's two T x T
products, 4 B T^2 C. Per image: call with batch 1."""

from __future__ import annotations

import torch

from benchmark.reference.unet import Attention, Conv, Linear, UNet


def forward_flops(sizes: dict, mode: str = "full") -> int:
    """FLOPs of one image's forward in `mode` ("full", "encode" or
    "decode"; "decode" counts what runs after the encoder)."""
    with torch.device("meta"):
        model = UNet(sizes)
    total = [0]

    def product(module, args, out):
        if isinstance(module, Conv):
            k = module.kernel_size[0] * module.kernel_size[1]
            total[0] += 2 * out.numel() * module.in_channels * k
        else:
            total[0] += 2 * out.numel() * module.in_features

    def attention(module, args, out):
        b, c, h, w = args[0].shape
        total[0] += 4 * b * (h * w) ** 2 * c

    handles = [m.register_forward_hook(product) for m in model.modules()
               if isinstance(m, (Conv, Linear))]
    handles += [m.register_forward_hook(attention) for m in model.modules()
                if isinstance(m, Attention)]
    side = sizes["image_size"]
    x = torch.empty(1, side, side, sizes["in_channels"], device="meta")
    t = torch.empty(1, device="meta")
    with torch.no_grad():
        if mode == "decode":
            cache = model(x, t, mode="encode")
            total[0] = 0
            model(x, t, mode="decode", cache=cache)
        else:
            model(x, t, mode=mode)
    for h in handles:
        h.remove()
    return total[0]
