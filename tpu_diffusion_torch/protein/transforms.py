"""Graph/structure transforms on padded dense protein batches.

Counterpart of `tpu_diffusion/protein/transforms.py` (rebuilds `amortised
diffusion/src/transforms/`):
  * `pyg_transforms.py` KnnGraph / RadiusGraph / AddLabel / OneHotEncode ->
    dense masked pair-mask builders + tensor transforms (SaveGraphToDisk is
    `FileDataset.write` in data/storage.py);
  * `frame_transforms.py` backbone `OrientationFrames` (Gram-Schmidt frames
    from N/CA/C) and the ideal backbone constants;
  * biotite_transforms.py's structure->graph step is `positions_to_graph`
    (scale + center), shared with protein/data.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tpu_diffusion_torch.protein.geometry import center
from tpu_diffusion_torch.protein.gvp import norm_no_nan

Tensor = torch.Tensor

# Ideal backbone geometry (frame_transforms.py constants)
IDEAL_N_CA = 1.458   # Angstrom
IDEAL_CA_C = 1.525
IDEAL_C_N = 1.329
IDEAL_CA_CA = 3.80
IDEAL_N_CA_C_ANGLE = 1.937  # rad (~111 deg)


def _no_self(mask: Tensor) -> Tensor:
    n = mask.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=mask.device)
    return (mask[:, :, None] & mask[:, None, :]) & ~eye


def pairwise_dist(pos: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    d = torch.sqrt(((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)
                   + 1e-12)
    return d, _no_self(mask)


def full_graph(mask: Tensor) -> Tensor:
    """Fully-connected pair mask without self loops (torch_utils.py:80-84)."""
    return _no_self(mask)


def radius_graph(pos: Tensor, mask: Tensor, radius: float) -> Tensor:
    """Edges within `radius` (pyg_transforms RadiusGraph)."""
    d, valid = pairwise_dist(pos, mask)
    return valid & (d <= radius)


def knn_graph(pos: Tensor, mask: Tensor, k: int) -> Tensor:
    """k nearest neighbours per node (pyg_transforms KnnGraph). Returns a
    dense [B, N, N] mask with True where j is among i's k nearest: every j
    within the k-th smallest distance, so a tie at the k-th distance keeps
    all its members, as in the JAX function."""
    d, valid = pairwise_dist(pos, mask)
    d = torch.where(valid, d, torch.inf)
    kth = -torch.topk(-d, min(k, d.shape[-1]), dim=-1).values[..., -1:]
    return valid & (d <= kth)


def one_hot_encode(labels: Tensor, num_classes: int) -> Tensor:
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def positions_to_graph(coords: Tensor, scale: float = 1.0 / 15.0) -> Tensor:
    """Scale + COM-center raw coordinates (torch_utils.py:67-78)."""
    return center(coords[None] * scale)[0]


class OrientationFrames(NamedTuple):
    """Backbone rigid frames: rotation [.., N, 3, 3] + translation [.., N, 3]
    (frame_transforms.py:11-321's Gram-Schmidt construction)."""

    rotations: Tensor
    translations: Tensor

    @classmethod
    def from_backbone(cls, n_pos: Tensor, ca_pos: Tensor, c_pos: Tensor
                      ) -> "OrientationFrames":
        """Gram-Schmidt: e1 along CA->C, e2 orthogonalized CA->N, e3 cross."""
        v1 = c_pos - ca_pos
        v2 = n_pos - ca_pos
        e1 = v1 / norm_no_nan(v1, keepdims=True)
        u2 = v2 - (e1 * v2).sum(-1, keepdim=True) * e1
        e2 = u2 / norm_no_nan(u2, keepdims=True)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        rot = torch.stack([e1, e2, e3], dim=-1)
        return cls(rotations=rot, translations=ca_pos)

    def apply(self, local: Tensor) -> Tensor:
        """Map local coordinates into the global frame."""
        return torch.einsum("...ij,...j->...i", self.rotations, local) \
            + self.translations

    def invert_apply(self, global_pos: Tensor) -> Tensor:
        return torch.einsum("...ji,...j->...i", self.rotations,
                            global_pos - self.translations)


def ideal_backbone_from_ca(ca_pos: Tensor) -> Tuple[Tensor, Tensor]:
    """Place idealized N and C atoms around each C-alpha using neighbour
    directions (the frame_transforms idealization used when only CA traces
    exist). Returns (n_pos, c_pos) of the same shape as ca_pos."""
    # Edge-extrapolated neighbour directions (not a roll, which would borrow
    # the opposite chain end for the terminal residues). The terminal
    # residue borrows the ADJACENT bond's direction: an exact antiparallel
    # to_prev/to_next would make the N/C directions collinear and
    # degenerate the Gram-Schmidt frame.
    fwd = ca_pos[..., 1:, :] - ca_pos[..., :-1, :]        # [..., L-1, 3]
    if fwd.shape[-2] >= 2:
        head = -fwd[..., 1:2, :]    # ca[-1] ~ ca[0] - (ca[2] - ca[1])
        tail = fwd[..., -2:-1, :]   # ca[L] ~ ca[L-1] + (ca[L-2]-ca[L-3])
    else:  # 2-residue chain: frames are underdetermined either way
        head = -fwd[..., :1, :]
        tail = fwd[..., -1:, :]
    to_next = torch.cat([fwd, tail], dim=-2)
    to_prev = torch.cat([head, -fwd], dim=-2)
    e_next = to_next / norm_no_nan(to_next, keepdims=True)
    e_prev = to_prev / norm_no_nan(to_prev, keepdims=True)
    c_pos = ca_pos + IDEAL_CA_C * e_next
    n_pos = ca_pos + IDEAL_N_CA * e_prev
    return n_pos, c_pos
