"""Device-resident dataset cache: stage once, draw minibatches on the device.

Counterpart of `tpu_diffusion/data/device_cache.py`. The dataset goes to the
card once; each minibatch is an index draw, a gather and an optional flip,
all device ops from an explicit generator, so `Trainer.fit_scanned` moves
no batch from the host. Sampling is uniform with replacement, which makes
every batch a pure function of its generator's seed: resume-exact by
construction. Each sampler is `sample(generator) -> batch`.

The JAX functions take a `mesh` (replicate the dataset, shard the batch);
the port's parallelism is not written yet (ROADMAP A10), so these take a
device and no mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_diffusion_torch.losses.cfm import sinkhorn_assignment
from tpu_diffusion_torch.models.unet import resolve_device

Tensor = torch.Tensor


def stage(images: np.ndarray, device="cuda",
          dtype: torch.dtype = torch.float32) -> Tensor:
    """Upload a [N, H, W, C] image array to the device once."""
    return torch.as_tensor(np.asarray(images), dtype=dtype,
                           device=resolve_device(device))


def sample_batch(images: Tensor, generator: torch.Generator,
                 batch_size: int, flip: bool = False) -> Tensor:
    """A [batch_size, ...] minibatch drawn on the images' device: uniform
    rows with replacement, and with `flip` each image mirrored left-right
    with probability 1/2."""
    idx = torch.randint(0, images.shape[0], (batch_size,),
                        generator=generator, device=images.device)
    batch = images[idx]
    if flip:
        do = torch.rand((batch_size,), generator=generator,
                        device=images.device) < 0.5
        batch = torch.where(do[:, None, None, None], batch.flip(2), batch)
    return batch


def make_protein_sampler(positions, lengths, batch_size: int,
                         device="cuda"):
    """Device-resident counterpart of `protein.data.protein_batches`.

    Stages the padded [N, L, 3] positions and the [N] lengths once and
    returns `sample(generator) -> {"pos": [B, L, 3], "mask": [B, L]}`; the
    mask is rebuilt on the device from the gathered lengths."""
    device = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions), dtype=torch.float32,
                          device=device)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                           device=device)
    col = torch.arange(pos.shape[1], device=device)

    def sample(generator: torch.Generator):
        idx = torch.randint(0, pos.shape[0], (batch_size,),
                            generator=generator, device=device)
        return {"pos": pos[idx], "mask": col[None, :] < lens[idx][:, None]}

    return sample


def make_cfm_pair_sampler(images: Tensor, batch_size: int,
                          flip: bool = False,
                          ot: Optional[str] = "sinkhorn", reg: float = 0.05):
    """Batch sampler for paired CFM losses, on the images' device.

    `sample(generator) -> (x0, x1)`: x1 a dataset minibatch, x0 ~ N(0, I),
    the pair coupled by entropic minibatch OT (`losses.cfm.
    sinkhorn_assignment`, a column sampled from the plan per row) with
    `ot="sinkhorn"`, or independent with `ot=None`."""
    if ot not in ("sinkhorn", None):
        raise ValueError(f"unknown on-device coupling: {ot!r} "
                         "(exact OT needs the host pipeline)")

    def sample(generator: torch.Generator):
        x1 = sample_batch(images, generator, batch_size, flip=flip)
        x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                         device=x1.device)
        if ot == "sinkhorn":
            x1 = x1[sinkhorn_assignment(x0, x1, reg=reg,
                                        generator=generator)]
        return (x0, x1)

    return sample
