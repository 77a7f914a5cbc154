"""R^3 translation diffusion and the combined SE(3) frame diffuser.

Counterpart of `tpu_diffusion/protein/se3.py` (rebuilds `amortised
diffusion/src/diffusion/r3_diffuser.py`, VP-SDE over translations with
`coordinate_scaling`, and `se3_diffuser.py:30-271`, SO3Diffuser +
R3Diffuser over rigid frames, with a minimal rigid type). Draws come from
the `generator` passed first, or are handed in by keyword (`z=`,
`noise=`, and the rotation draws' `u=`/`axis=`) to replay another stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu_diffusion_torch.protein.so3 import SO3Diffuser, rotvec_to_matrix

Tensor = torch.Tensor


def _randn(generator, like: Tensor) -> Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


class Rigid(NamedTuple):
    """Rigid frames: rotations [..., 3, 3] + translations [..., 3]."""

    rots: Tensor
    trans: Tensor

    def compose_rotvec(self, rotvec: Tensor) -> "Rigid":
        return self._replace(rots=self.rots @ rotvec_to_matrix(rotvec))

    def apply(self, points: Tensor) -> Tensor:
        return torch.einsum("...ij,...j->...i", self.rots, points) \
            + self.trans

    @classmethod
    def identity(cls, shape: Tuple[int, ...], device=None) -> "Rigid":
        eye = torch.eye(3, device=device)
        return cls(rots=eye.expand(tuple(shape) + (3, 3)),
                   trans=torch.zeros(tuple(shape) + (3,), device=device))


class R3Diffuser:
    """VP-SDE over translations in a scaled coordinate system
    (r3_diffuser.py: coordinate_scaling default 0.1)."""

    def __init__(self, min_b: float = 0.1, max_b: float = 20.0,
                 coordinate_scaling: float = 0.1):
        self.min_b = min_b
        self.max_b = max_b
        self.coordinate_scaling = coordinate_scaling

    def _scale(self, x: Tensor) -> Tensor:
        return x * self.coordinate_scaling

    def _unscale(self, x: Tensor) -> Tensor:
        return x / self.coordinate_scaling

    def b_t(self, t: Tensor) -> Tensor:
        return self.min_b + t * (self.max_b - self.min_b)

    def marginal_b_t(self, t: Tensor) -> Tensor:
        """int_0^t b(s) ds."""
        return t * self.min_b + t**2 * (self.max_b - self.min_b) / 2

    def forward_marginal(self, generator: Optional[torch.Generator],
                         x0: Tensor, t: Tensor, *,
                         z: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
        """x_t | x_0 and the exact score at the sample; `z` (x0's shape,
        standard normal) may be handed in."""
        x0s = self._scale(x0)
        ib = self.marginal_b_t(t)[..., None, None]
        mean = torch.exp(-ib / 2) * x0s
        std = torch.sqrt(1 - torch.exp(-ib))
        if z is None:
            z = _randn(generator, x0)
        xt = mean + std * z
        score = -(xt - mean) / torch.clamp(std**2, min=1e-8)
        return self._unscale(xt), score

    def score(self, xt: Tensor, x0: Tensor, t: Tensor) -> Tensor:
        xts, x0s = self._scale(xt), self._scale(x0)
        ib = self.marginal_b_t(t)[..., None, None]
        mean = torch.exp(-ib / 2) * x0s
        var = 1 - torch.exp(-ib)
        return -(xts - mean) / torch.clamp(var, min=1e-8)

    def score_scaling(self, t: Tensor) -> Tensor:
        return 1.0 / torch.sqrt(torch.clamp(
            1 - torch.exp(-self.marginal_b_t(t)), min=1e-8))

    def reverse_step(self, generator: Optional[torch.Generator], xt: Tensor,
                     score: Tensor, t: Tensor, dt: float,
                     center: bool = True, noise_scale: float = 1.0, *,
                     noise: Optional[Tensor] = None) -> Tensor:
        """One reverse step; `noise` (xt's shape, standard normal) may be
        handed in."""
        xts = self._scale(xt)
        bt = self.b_t(t)[..., None, None]
        drift = -0.5 * bt * xts - bt * score
        if noise is None:
            noise = _randn(generator, xt)
        x = xts - drift * dt + noise_scale * torch.sqrt(bt * dt) * noise
        if center:
            x = x - x.mean(dim=-2, keepdim=True)
        return self._unscale(x)


class SE3Diffuser:
    """Joint diffusion over rigid frames (se3_diffuser.py:30-271):
    independent SO(3) rotation and R^3 translation processes with optional
    per-component freezing (diffuse_rot / diffuse_trans flags)."""

    def __init__(self, so3: Optional[SO3Diffuser] = None,
                 r3: Optional[R3Diffuser] = None,
                 diffuse_rot: bool = True, diffuse_trans: bool = True):
        self.so3 = so3 or SO3Diffuser()
        self.r3 = r3 or R3Diffuser()
        self.diffuse_rot = diffuse_rot
        self.diffuse_trans = diffuse_trans

    def forward_marginal(self, generator: Optional[torch.Generator],
                         frames: Rigid, t: Tensor, *,
                         u: Optional[Tensor] = None,
                         axis: Optional[Tensor] = None,
                         z: Optional[Tensor] = None
                         ) -> Tuple[Rigid, Tensor, Tensor]:
        """Returns (noised frames, rot score, trans score); the rotation
        draws `u`, `axis` and the translation noise `z` may be handed in."""
        if self.diffuse_rot:
            rots_t, rotvec = self.so3.forward_marginal(
                generator, frames.rots, t, u=u, axis=axis)
            rot_score = self.so3.score(t, rotvec)
        else:
            rots_t, rot_score = frames.rots, torch.zeros_like(frames.trans)
        if self.diffuse_trans:
            trans_t, trans_score = self.r3.forward_marginal(
                generator, frames.trans, t, z=z)
        else:
            trans_t = frames.trans
            trans_score = torch.zeros_like(frames.trans)
        return Rigid(rots_t, trans_t), rot_score, trans_score

    def reverse_step(self, generator: Optional[torch.Generator],
                     frames: Rigid, rot_score: Tensor, trans_score: Tensor,
                     t: Tensor, dt: float, *,
                     rot_noise: Optional[Tensor] = None,
                     trans_noise: Optional[Tensor] = None) -> Rigid:
        rots = frames.rots
        trans = frames.trans
        if self.diffuse_rot:
            rots = self.so3.reverse_step(generator, rots, rot_score, t, dt,
                                         noise=rot_noise)
        if self.diffuse_trans:
            trans = self.r3.reverse_step(generator, trans, trans_score, t,
                                         dt, noise=trans_noise)
        return Rigid(rots, trans)

    def sample_ref(self, generator: Optional[torch.Generator],
                   shape: Tuple[int, ...], *, u: Optional[Tensor] = None,
                   axis: Optional[Tensor] = None,
                   z: Optional[Tensor] = None) -> Rigid:
        """Reference (prior) frames: IGSO3 rotations at t=1 + N(0, I)/scale
        translations, on the rotation diffuser's device."""
        rv = self.so3.sample(generator, torch.ones(()), shape, u=u,
                             axis=axis)
        if z is None:
            z = torch.randn(tuple(shape) + (3,), generator=generator,
                            device=rv.device)
        return Rigid(rotvec_to_matrix(rv), z / self.r3.coordinate_scaling)
