"""Motif-scaffolding reconstruction guidance for protein sampling.

Counterpart of `tpu_diffusion/protein/conditioner.py`: during reverse
sampling, predict the noise with a graph to the positions, total-denoise to
x0_hat, Kabsch-align the sampled motif residues onto the reference motif per
graph, take an l1/l2 loss divided by the motif length, and step the
positions along -grad scaled by guidance_scale * a * (1 - a), with a the
per-step alpha. The gradient is `torch.autograd.grad` with respect to the
positions alone: the parameters get no `.grad`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_diffusion_torch.protein.geometry import kabsch_align
from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE, ProteinBatch

Tensor = torch.Tensor


@dataclass
class Structconditioner:
    """Holds the motif condition (tensors on the sampler's device); `guide`
    returns the position update and the step's eps_hat."""

    motif_pos: Tensor          # [M, 3] reference motif coordinates (scaled)
    motif_indices: Tensor      # [M] residue indices into the padded chain
    guidance_scale: float = 1500.0
    loss_type: str = "l2"
    align: bool = True

    def motif_loss(self, pos: Tensor) -> Tensor:
        """Per-graph motif loss; pos: [B, N, 3] -> [B]. The sampled motif is
        Kabsch-aligned onto the reference motif, the mean l1/l2 loss is
        taken in the motif's frame and divided again by the motif length."""
        sampled = pos[:, self.motif_indices, :]            # [B, M, 3]
        m = self.motif_pos.shape[0]
        target = self.motif_pos.expand_as(sampled)
        aligned = kabsch_align(sampled, target) if self.align else sampled
        if self.loss_type == "l1":
            base = (aligned - target).abs().mean(dim=(-2, -1))
        else:
            base = ((aligned - target) ** 2).mean(dim=(-2, -1))
        return base / m

    def guide(self, batch: ProteinBatch, score_model, step: int,
              diffuser: HoogeboomGraphSDE):
        """(update, eps_hat): the update -gs * a * (1-a) * grad_pos
        loss(x0_hat(pos)), and the eps_hat of the same forward, detached
        (the plain forward of these positions and t)."""
        a = diffuser.alphas[step]
        abar = diffuser.alphas_cumprod[step]
        t = torch.full((batch.num_graphs,), float(step),
                       dtype=batch.pos.dtype,
                       device=batch.pos.device) / diffuser.num_steps
        with torch.enable_grad():
            pos = batch.pos.detach().requires_grad_(True)
            eps_hat = score_model(batch._replace(pos=pos), t)
            x0 = (pos - torch.sqrt(1.0 - abar) * eps_hat) / torch.sqrt(abar)
            (grad,) = torch.autograd.grad(self.motif_loss(x0).sum(), [pos])
        scale = self.guidance_scale * a * (1.0 - a)
        return -scale * grad * batch.mask[..., None], eps_hat.detach()

    def apply(self, batch: ProteinBatch, score_model, step: int,
              diffuser: HoogeboomGraphSDE) -> Tensor:
        """The position update of `guide`: the JAX conditioner's `apply`,
        kept for that interface (the reverse chain calls `guide`)."""
        return self.guide(batch, score_model, step, diffuser)[0]

    def final_loss(self, batch: ProteinBatch) -> Tensor:
        """Per-graph motif loss of the final sample."""
        return self.motif_loss(batch.pos)


def place_indices_block_within_bounds(indices, length: int,
                                      center_at: Optional[int] = None
                                      ) -> Tensor:
    """Center a contiguous motif index block inside [0, length)."""
    indices = torch.as_tensor(indices)
    lo = int(indices.min())
    span = int(indices.max()) - lo + 1
    start = (length - span) // 2 if center_at is None else center_at
    return indices - lo + start
