"""InceptionV3 (FID variant, pool3 2048-d features), in PyTorch.

Counterpart of `tpu_diffusion/eval/inception.py`: the standard FID feature
network (`pt_inception-2015-12-05`: InceptionA-E blocks with the TF-style
asymmetric convolutions). Branch average pools divide border windows by
the number of real elements (`count_include_pad=False`, pytorch-fid's
FIDInceptionA/C/E); the last block max-pools. Submodules carry the flax
module names (`Mixed_5b.branch5x5_2.conv`, `.bn`), so `convert.py` maps the
JAX variable tree, or an .npz of it, onto this one by name.

Input: images in [-1, 1], NHWC, any HxW, resized to 299x299 bilinear (as
`jax.image.resize` does); one channel is repeated to three. Runs in fp32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_diffusion_torch.conditioning.likelihoods import resize_bilinear
from tpu_diffusion_torch.eval.fid import (FeatureFn, feature_fn,
                                          flax_default_init_)
from tpu_diffusion_torch.models.unet import resolve_device


class BatchNormNoScale(nn.Module):
    """Inference BatchNorm with eps 1e-3 and no scale (flax `BatchNorm(
    use_scale=False)`): `bias` learned, `mean` and `var` the running
    statistics."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, None, self.bias,
                            training=False, eps=1e-3)


class BasicConv(nn.Module):
    """Conv (no bias) + BatchNorm(eps=1e-3, no scale) + ReLU. "SAME"
    padding of a stride-1 conv with odd kernels is symmetric: k // 2."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 same: bool = False, device=None):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else kernel
        padding = tuple(k // 2 for k in kernel) if same else 0
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False,
                              device=device)
        self.bn = BatchNormNoScale(cout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, device=None):
        super().__init__()
        dev = dict(device=device)
        self.branch1x1 = BasicConv(cin, 64, 1, **dev)
        self.branch5x5_1 = BasicConv(cin, 48, 1, **dev)
        self.branch5x5_2 = BasicConv(48, 64, 5, same=True, **dev)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, **dev)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, same=True, **dev)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, same=True, **dev)
        self.branch_pool = BasicConv(cin, pool_features, 1, **dev)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        dev = dict(device=device)
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, **dev)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, **dev)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, same=True, **dev)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, **dev)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, device=None):
        super().__init__()
        dev = dict(device=device, same=True)
        self.branch1x1 = BasicConv(cin, 192, 1, **dev)
        self.branch7x7_1 = BasicConv(cin, c7, 1, **dev)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), **dev)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), **dev)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1, **dev)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), **dev)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), **dev)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), **dev)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), **dev)
        self.branch_pool = BasicConv(cin, 192, 1, **dev)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        dev = dict(device=device)
        self.branch3x3_1 = BasicConv(cin, 192, 1, **dev)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2, **dev)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1, **dev)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), same=True, **dev)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), same=True, **dev)
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2, **dev)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str = "avg", device=None):
        super().__init__()
        dev = dict(device=device, same=True)
        self.pool_kind = pool_kind  # the FID variant max-pools in Mixed_7c
        self.branch1x1 = BasicConv(cin, 320, 1, **dev)
        self.branch3x3_1 = BasicConv(cin, 384, 1, **dev)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), **dev)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), **dev)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1, **dev)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, **dev)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), **dev)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), **dev)
        self.branch_pool = BasicConv(cin, 192, 1, **dev)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool_kind == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg3(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """Pool3 feature extractor: [B, H, W, C] in [-1, 1] -> [B, 2048]."""

    def __init__(self, device=None):
        super().__init__()
        dev = dict(device=device)
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, **dev)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, **dev)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, same=True, **dev)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, **dev)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, **dev)
        self.Mixed_5b = InceptionA(192, 32, **dev)
        self.Mixed_5c = InceptionA(256, 64, **dev)
        self.Mixed_5d = InceptionA(288, 64, **dev)
        self.Mixed_6a = InceptionB(288, **dev)
        self.Mixed_6b = InceptionC(768, 128, **dev)
        self.Mixed_6c = InceptionC(768, 160, **dev)
        self.Mixed_6d = InceptionC(768, 160, **dev)
        self.Mixed_6e = InceptionC(768, 192, **dev)
        self.Mixed_7a = InceptionD(768, **dev)
        self.Mixed_7b = InceptionE(1280, "avg", **dev)
        self.Mixed_7c = InceptionE(2048, "max", **dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (299, 299):
            x = resize_bilinear(x, 299, 299)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # global average pool -> 2048


def load_inception_fn(path: Optional[str] = None, device="cuda"
                      ) -> FeatureFn:
    """Feature fn from an .npz of the JAX package's named variables
    (`params/...`, `batch_stats/...`, as `tpu_diffusion.eval.inception.
    load_inception_fn` reads it); the random initialisation from torch seed
    0 when `path` is None (architecture/latency testing only — NOT a valid
    FID)."""
    from tpu_diffusion_torch.convert import load_flax_npz
    net = flax_default_init_(InceptionV3Features(),
                             torch.Generator().manual_seed(0))
    if path:
        load_flax_npz(net, dict(np.load(path)))
    return feature_fn(net.to(resolve_device(device)).eval())
