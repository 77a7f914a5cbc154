"""Differentiable rigid-body geometry (Kabsch alignment, rototranslation).

Counterpart of `tpu_diffusion/protein/geometry.py`. `kabsch` is batched over
leading dimensions (the JAX function takes one graph and is vmapped). The
cross-covariance gets the same 1e-8 * I tie-break before the SVD, which
keeps the SVD's backward finite when singular values collide: the motif
guidance differentiates through it.

On a CUDA tensor `torch.linalg.svd` synchronises the device with the host
(PyTorch documents it); the SVD stays on the device all the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def masked_mean(x: Tensor, mask: Optional[Tensor], axis: int,
                keepdims: bool = True) -> Tensor:
    """Mean over `axis` counting only mask==True rows. mask: x.shape[:-1]."""
    if mask is None:
        return x.mean(dim=axis, keepdim=keepdims)
    m = mask[..., None].to(x.dtype)
    total = (x * m).sum(dim=axis, keepdim=keepdims)
    count = torch.clamp(m.sum(dim=axis, keepdim=keepdims), min=1.0)
    return total / count


def center(pos: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Remove the (masked) center of mass. pos: [..., N, 3]."""
    return pos - masked_mean(pos, mask, axis=-2)


def kabsch(mobile: Tensor, target: Tensor,
           weights: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Optimal rotation R and translation u with R @ mobile + u ~= target.

    mobile/target: [..., N, 3]; weights: [..., N] or None. Differentiable
    through the SVD. Returns (R [..., 3, 3], u [..., 3]).
    """
    if weights is None:
        w = torch.ones(mobile.shape[:-1], dtype=mobile.dtype,
                       device=mobile.device)
    else:
        w = weights
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-8)
    mu_m = (mobile * w[..., None]).sum(dim=-2)
    mu_t = (target * w[..., None]).sum(dim=-2)
    m = mobile - mu_m[..., None, :]
    t = target - mu_t[..., None, :]
    eye = torch.eye(3, dtype=mobile.dtype, device=mobile.device)
    h = (m * w[..., None]).transpose(-1, -2) @ t + 1e-8 * eye
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    # diag(1, 1, det)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    rot = (v * d[..., None, :]) @ ut
    trans = mu_t - (rot @ mu_m[..., None])[..., 0]
    return rot, trans


def kabsch_align(mobile: Tensor, target: Tensor,
                 weights: Optional[Tensor] = None) -> Tensor:
    """Return mobile rototranslated onto target."""
    rot, trans = kabsch(mobile, target, weights)
    return mobile @ rot.transpose(-1, -2) + trans[..., None, :]


def rmsd(a: Tensor, b: Tensor) -> Tensor:
    """Root-mean-square deviation after NO alignment. a,b: [..., N, 3]."""
    return torch.sqrt(((a - b) ** 2).sum(dim=-1).mean(dim=-1))


def aligned_rmsd(mobile: Tensor, target: Tensor) -> Tensor:
    return rmsd(kabsch_align(mobile, target), target)


def rototranslate(pos: Tensor, rot: Tensor, trans: Tensor) -> Tensor:
    """Apply (R, t) to [..., N, 3] positions."""
    return pos @ rot.transpose(-1, -2) + trans[..., None, :]


def random_rotation_matrix(generator: Optional[torch.Generator] = None,
                           dtype=torch.float32, device=None) -> Tensor:
    """Uniform random rotation via QR of a Gaussian."""
    a = torch.randn((3, 3), generator=generator, dtype=dtype, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q * torch.linalg.det(q)
