"""Protein diffusion training objective.

Counterpart of `tpu_diffusion/protein/resdiff.py`: t ~ U(1e-3, 1-1e-3) per
graph, COM-free noising, eps_hat = model(noised, t), the DSM MSE of eps and
eps_hat, plus auxiliary losses gated at t <= aux_cutoff with weight
`aux_weight`: the backbone MSE between the totally denoised positions and
the truth, and the distogram MSE between sequential-neighbour distances
("sequential") or all pairwise distances (any other mode). `motif_fn`
adds a motif loss on the denoised batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE, ProteinBatch

Tensor = torch.Tensor


def sequential_distances(pos: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Distances between chain neighbours (i, i+1). Returns (d [B, N-1],
    valid [B, N-1])."""
    d = torch.sqrt(((pos[:, 1:] - pos[:, :-1]) ** 2).sum(-1) + 1e-12)
    return d, mask[:, 1:] & mask[:, :-1]


def pairwise_distances(pos: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    d = torch.sqrt(((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)
                   + 1e-12)
    n = pos.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    return d, (mask[:, :, None] & mask[:, None, :]) & ~eye


def resdiff_loss(generator: Optional[torch.Generator],
                 model_apply: Callable[[ProteinBatch, Tensor], Tensor],
                 diffuser: HoogeboomGraphSDE, batch: ProteinBatch,
                 aux_weight: float = 0.25, aux_cutoff: float = 0.25,
                 distogram: str = "sequential",
                 motif_fn: Optional[Callable] = None,
                 t: Optional[Tensor] = None, eps: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (total_loss, metrics). `t` ([B]) and `eps` (COM-free, like
    the batch) are drawn from `generator` unless passed."""
    b = batch.num_graphs
    if t is None:
        t = 1e-3 + (1.0 - 2e-3) * torch.rand(
            (b,), generator=generator, device=batch.pos.device)
    noised, eps = diffuser.noising(generator, batch, t, eps)
    eps_hat = model_apply(noised, t)

    node_w = batch.mask[..., None].to(eps.dtype)
    n_coords = torch.clamp(node_w.sum(), min=1.0) * 3
    dsm = (node_w * (eps - eps_hat) ** 2).sum() / n_coords

    # total denoise with the predicted noise -> x0_hat
    denoised = diffuser.denoising(noised, eps_hat, t)
    gate = (t <= aux_cutoff).to(eps.dtype)[:, None, None]
    bb_sq = node_w * (denoised.pos - batch.pos) ** 2 * gate
    bb = bb_sq.sum() / torch.clamp((node_w * gate).sum() * 3, min=1.0)

    dist = sequential_distances if distogram == "sequential" \
        else pairwise_distances
    d_hat, valid = dist(denoised.pos, batch.mask)
    d_true, _ = dist(batch.pos, batch.mask)
    # gate is [B,1,1]: drop trailing axes down to the rank of `valid`
    gate2 = gate if valid.ndim == 3 else gate[..., 0]
    w = valid.to(eps.dtype) * gate2
    disto = (w * (d_hat - d_true) ** 2).sum() / torch.clamp(w.sum(), min=1.0)

    total = dsm + aux_weight * (bb + disto)
    metrics = {"dsm": dsm, "backbone_mse": bb, "distogram_mse": disto}
    if motif_fn is not None:
        motif = motif_fn(denoised, batch)
        total = total + aux_weight * motif
        metrics["motif"] = motif
    metrics["loss"] = total
    return total, metrics
