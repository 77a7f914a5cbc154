"""What the benchmark makes from `--seed` and hands to both sides: the
UNet's weights and the training images, drawn on the device by a
`torch.Generator` there in a few large calls, and the seeds of the other
streams (x_T, the training draws, the sample of answers checked).
"""

from __future__ import annotations

import torch

from benchmark.reference.unet import Norm, UNet

_MASK = (1 << 64) - 1
# one stream of draws per purpose
WEIGHTS, NOISE, IMAGES, TRAIN_DRAWS, CHECK = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for `stream` of the run seeded `seed` (splitmix64 of
    both), so every bit depends on both and any whole seed is taken."""
    z = ((seed & _MASK) * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03
         + 0x632BE59BD9B4E019) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def make_weights(sizes: dict, seed: int, device) -> dict:
    """{name: fp32 tensor} for every parameter of the UNet of `sizes`, from
    one normal draw: weights N(0, 1 / fan_in), biases N(0, 0.02^2), norm
    scales 1 + N(0, 0.1^2), norm shifts N(0, 0.1^2). Nothing is zero, so
    eps is not identically 0."""
    with torch.device("meta"):
        shape_model = UNet(sizes)
    norms = {n for n, m in shape_model.named_modules() if isinstance(m, Norm)}
    named = list(shape_model.named_parameters())
    flat = torch.randn(sum(p.numel() for _, p in named),
                       generator=generator(seed, WEIGHTS, device),
                       device=device)
    out, at = {}, 0
    for name, p in named:
        v = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        owner, kind = name.rsplit(".", 1)
        if owner in norms:
            v = v * 0.1 + (1.0 if kind == "weight" else 0.0)
        elif kind == "weight":
            v = v / p[0].numel() ** 0.5
        else:
            v = v * 0.02
        out[name] = v.contiguous()
    return out


def make_images(n: int, side: int, seed: int, device) -> torch.Tensor:
    """n images [n, side, side, 3] in [-1, 1]: uniform noise."""
    return torch.rand((n, side, side, 3), generator=generator(
        seed, IMAGES, device), device=device) * 2 - 1


def reference_unet(sizes: dict, seed: int, device, lowp=None) -> UNet:
    """The plain reference UNet with the seed's weights; `lowp` rounds the
    operands of its products (the control)."""
    ref = UNet(sizes, device=device)
    ref.load_state_dict(make_weights(sizes, seed, device))
    return ref.set_lowp(lowp)
