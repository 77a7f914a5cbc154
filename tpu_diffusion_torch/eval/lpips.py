"""LPIPS-style perceptual distance, in PyTorch.

Counterpart of `tpu_diffusion/eval/lpips.py`:

  lpips(x, y) = sum_l mean_hw || unit(f_l(x)) - unit(f_l(y)) ||^2

with `unit` the unit normalisation over channels, over the five stages of
a VGG16-topology feature pyramid. The default pyramid has random weights
from torch seed 123 (the JAX package's from flax key 123, which the port
cannot replay): self-consistent across runs of the port, NOT comparable to
published LPIPS(vgg) numbers nor to the JAX package's random LPIPS.
`load_lpips_fn` reads pretrained VGG16 weights and the learned heads from
a local .npz and gives the official formula. Runs in fp32 (`eval/fid.py:
full_fp32`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.eval.fid import flax_default_init_, full_fp32
from tpu_diffusion_torch.models.unet import resolve_device


class VGGFeaturePyramid(nn.Module):
    """VGG16-topology conv features: [B, H, W, 3] -> the pre-pool
    activation of each stage, NCHW. Convs carry the flax names
    (`Conv_0`..`Conv_12`)."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512, 512),
                 convs_per_stage: Sequence[int] = (2, 2, 3, 3, 3),
                 channels: int = 3, device=None):
        super().__init__()
        self.convs_per_stage = tuple(convs_per_stage)
        i, cin = 0, channels
        for w, n in zip(widths, convs_per_stage):
            for _ in range(n):
                self.add_module(f"Conv_{i}", nn.Conv2d(cin, w, 3, padding=1,
                                                       device=device))
                i, cin = i + 1, w

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x.permute(0, 3, 1, 2)
        i = 0
        for stage, n in enumerate(self.convs_per_stage):
            for _ in range(n):
                h = F.relu(getattr(self, f"Conv_{i}")(h))
                i += 1
            feats.append(h)
            if stage != len(self.convs_per_stage) - 1:
                h = F.max_pool2d(h, 2, stride=2)
        return feats


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True) + 1e-10)


class PerceptualDistance:
    """lpips-package-compatible callable: dist(x, y) -> [B], on NHWC images
    in [-1, 1].

    With `lin_weights`/`shift`/`scale` set (via `load_lpips_fn`) this is
    the official LPIPS formula: the lpips scaling layer, per-tap unit-
    normalized feature differences weighted by the learned per-channel
    heads, spatially averaged, summed over taps. Without them it is the
    unweighted random-feature variant."""

    def __init__(self, feature_fn: Optional[
                     Callable[[torch.Tensor], List[torch.Tensor]]] = None,
                 seed: int = 123,
                 lin_weights: Optional[List[torch.Tensor]] = None,
                 shift: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, device="cuda"):
        self.device = resolve_device(device)
        if feature_fn is None:
            net = flax_default_init_(VGGFeaturePyramid(),
                                     torch.Generator().manual_seed(seed))
            feature_fn = net.to(self.device).eval()
        self._fn = feature_fn
        self._lin = lin_weights
        self._shift = shift
        self._scale = scale

    def _distance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self._shift is not None:
            x = (x - self._shift) / self._scale
            y = (y - self._shift) / self._scale
        total = 0.0
        for layer, (a, b) in enumerate(zip(self._fn(x), self._fn(y))):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            if self._lin is not None:
                diff = diff * self._lin[layer].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff, 1), dim=(1, 2))
        return total

    @torch.no_grad()
    def __call__(self, x, y) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        if x.shape[-1] == 1:  # grayscale -> 3-channel, lpips convention
            x = x.repeat(1, 1, 1, 3)
            y = y.repeat(1, 1, 1, 3)
        with full_fp32():
            return self._distance(x, y)


def load_lpips_fn(path: str, device="cuda") -> PerceptualDistance:
    """Official LPIPS(vgg) from an .npz produced by
    scripts/import_inception_weights.py (`lpips` subcommand): VGG16 conv
    weights (params/Conv_{i}/kernel|bias), learned lin heads (lin/{l}), and
    the lpips scaling layer (shift/scale)."""
    from tpu_diffusion_torch.convert import load_flax_npz
    device = resolve_device(device)
    loaded = dict(np.load(path))
    net = VGGFeaturePyramid()
    load_flax_npz(net, loaded)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return PerceptualDistance(
        feature_fn=net.to(device).eval(),
        lin_weights=[tensor(loaded[f"lin/{layer}"]) for layer in range(5)],
        shift=tensor(loaded["shift"]), scale=tensor(loaded["scale"]),
        device=device)
