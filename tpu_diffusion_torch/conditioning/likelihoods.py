"""Forward operators ("likelihoods") for conditional generation, in PyTorch.

Counterpart of `tpu_diffusion/conditioning/likelihoods.py` (`Likelihood`,
`_patch_mask`, `Painting`, `InPainting`, `OutPainting`, `HyperResolution`,
`LIKELIHOODS`, `get_likelihood`). Layout NHWC; `loss` is per sample ([B]),
the scalar the reconstruction-guidance sampler differentiates through.

Random patch origins come from a `torch.Generator` on the input's device,
or are given (`origins=(h0, w0)`), so a test can feed the JAX draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Likelihood:
    def sample(self, generator: torch.Generator | None, x: torch.Tensor,
               origins=None) -> torch.Tensor:
        raise NotImplementedError

    def none_like(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _patch_mask(generator: torch.Generator | None, batch: int,
                image_size: int, patch_size: int, margin: int = 5,
                image_width: int | None = None, *, origins=None,
                device=None) -> torch.Tensor:
    """[B, H, W, 1] boolean mask, True inside one patch per image.

    Patch origin ~ U[margin, size - patch_size - margin) per axis, drawn
    with `generator` (rows first, then columns), or `origins = (h0, w0)`
    ([B] integers each) when given. `image_width` defaults to the height.
    """
    w_size = image_size if image_width is None else image_width

    def bounds(size):
        if patch_size + 2 * margin > size:
            raise ValueError(
                f"patch_size={patch_size} with margin={margin} does not fit "
                f"in a {size}-pixel axis (need patch_size <= "
                f"{size - 2 * margin})")
        lo, hi = margin, size - patch_size - margin
        return lo, max(hi, lo + 1)

    hb, wb = bounds(image_size), bounds(w_size)
    if origins is None:
        h0, w0 = (torch.randint(*b, (batch,), generator=generator,
                                device=device) for b in (hb, wb))
    else:
        h0, w0 = (torch.as_tensor(o, device=device) for o in origins)
    rows = torch.arange(image_size, device=device)
    cols = torch.arange(w_size, device=device)
    in_h = (rows[None, :] >= h0[:, None]) & (
        rows[None, :] < h0[:, None] + patch_size)     # [B, H]
    in_w = (cols[None, :] >= w0[:, None]) & (
        cols[None, :] < w0[:, None] + patch_size)     # [B, W]
    return (in_h[:, :, None] & in_w[:, None, :])[..., None]


@dataclass(frozen=True)
class Painting(Likelihood):
    patch_size: int = 20
    pad_value: float = -2.0

    @classmethod
    def from_configdict(cls, config):
        return cls(patch_size=config["patch_size"],
                   pad_value=config["pad_value"])

    def none_like(self, x: torch.Tensor) -> torch.Tensor:
        return torch.full_like(x, self.pad_value)

    def loss(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        """Masked SSE over the observed pixels, per sample."""
        diff = torch.where(self.observed_mask(condition), x - condition, 0.0)
        return torch.sum(diff ** 2, dim=tuple(range(1, x.ndim)))

    def observed_mask(self, condition: torch.Tensor) -> torch.Tensor:
        return condition != self.pad_value

    def _mask(self, generator, x, origins):
        return _patch_mask(generator, x.shape[0], x.shape[1],
                           self.patch_size, image_width=x.shape[2],
                           origins=origins, device=x.device)


@dataclass(frozen=True)
class InPainting(Painting):
    """Condition = image with a random patch blanked to pad_value."""

    def sample(self, generator, x, origins=None):
        return torch.where(self._mask(generator, x, origins),
                           self.pad_value, x)


@dataclass(frozen=True)
class OutPainting(Painting):
    """Condition = only a random patch kept; everything else pad_value."""

    def sample(self, generator, x, origins=None):
        return torch.where(self._mask(generator, x, origins), x,
                           self.pad_value)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` on NHWC: half-pixel centres,
    and a triangle kernel widened by the scale when downsampling
    (antialiasing), which is `antialias=True` here."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


@dataclass(frozen=True)
class HyperResolution(Likelihood):
    """Super-resolution operator: bilinear down to (th, tw), back up.
    `none_like` is zeros; the guidance loss is the mean MSE against the
    re-upscaled condition."""

    target_height: int = 16
    target_width: int = 16

    @classmethod
    def from_configdict(cls, config):
        return cls(target_height=config["target_height"],
                   target_width=config["target_width"])

    def downsample(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, self.target_height, self.target_width)

    def sample(self, generator, x, origins=None):
        del generator, origins  # deterministic operator
        return resize_bilinear(self.downsample(x), x.shape[1], x.shape[2])

    def none_like(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)

    def loss(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if tuple(condition.shape[1:3]) != (h, w):
            condition = resize_bilinear(condition, h, w)
        return torch.mean((condition - x) ** 2, dim=tuple(range(1, x.ndim)))


LIKELIHOODS = {
    "inpainting": InPainting,
    "outpainting": OutPainting,
    "hyperresolution": HyperResolution,
}


def get_likelihood(name: str):
    key = name.lower()
    if key not in LIKELIHOODS:
        raise NotImplementedError(f"Unknown likelihood {name!r}")
    return LIKELIHOODS[key]
