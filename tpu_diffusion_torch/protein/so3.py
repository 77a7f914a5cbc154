"""IGSO(3) diffusion on rotations.

Counterpart of `tpu_diffusion/protein/so3.py` (rebuilds `amortised
diffusion/src/diffusion/{so3_diffuser,igso3}.py`, FrameDiff-derived). The
isotropic Gaussian on SO(3):

  f(omega | sigma) = sum_l (2l+1) exp(-l(l+1) sigma^2 / 2)
                     sin((l+1/2) omega) / sin(omega / 2)

The (sigma, omega) tables are built in numpy float64 at construction, as in
the JAX module, then put on `device` in fp32 (as `jnp.asarray` does with
x64 off). Sampling and scoring are table lookups on the device: a
left-sided `searchsorted`, and a sigma index truncated as `astype(int32)`
truncates. Every draw comes from the `generator` passed first, or is
handed in by keyword (`u=`, `axis=`, `noise=`) to replay another stream.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _igso3_expansion(omega: np.ndarray, sigma: np.ndarray,
                     n_l: int = 200) -> np.ndarray:
    """f(omega | sigma): [S, O] truncated series."""
    l = np.arange(n_l)[:, None, None]                      # [L, 1, 1]
    o = omega[None, None, :]                               # [1, 1, O]
    s2 = (sigma**2)[None, :, None]                         # [1, S, 1]
    terms = ((2 * l + 1) * np.exp(-l * (l + 1) * s2 / 2)
             * np.sin((l + 0.5) * o) / np.sin(o / 2))
    return np.clip(terms.sum(0), 1e-12, None)              # [S, O]


def _f32(x: float, device) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class SO3Diffuser:
    """Forward/reverse rotation diffusion with FrameDiff's logarithmic
    sigma(t) schedule."""

    def __init__(self, min_sigma: float = 0.1, max_sigma: float = 1.5,
                 num_sigma: int = 100, num_omega: int = 500,
                 n_l: int = 200, cache_dir: Optional[str] = None,
                 device=None):
        self.min_sigma = min_sigma
        self.max_sigma = max_sigma
        self.num_sigma = num_sigma
        self.device = device
        self._omega = np.linspace(1e-4, np.pi, num_omega)
        self._sigma_grid = np.linspace(min_sigma, max_sigma, num_sigma)
        pdf = None
        cache_path = None
        if cache_dir is not None:
            # disk-cached like the reference's
            # configs/diffusion/default.yaml:33 cache_dir (same file name
            # and contents as the JAX package's)
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(
                cache_dir,
                f"igso3_{min_sigma}_{max_sigma}_{num_sigma}_"
                f"{num_omega}_{n_l}.npz")
            if os.path.exists(cache_path):
                pdf = np.load(cache_path)["pdf"]
        if pdf is None:
            pdf = _igso3_expansion(self._omega, self._sigma_grid, n_l)
            if cache_path is not None:
                np.savez(cache_path, pdf=pdf)
        # density of omega includes the Haar factor (1-cos omega)/pi
        haar = (1 - np.cos(self._omega)) / np.pi
        self._pdf = pdf * haar[None, :]
        cdf = np.cumsum(self._pdf, axis=1)
        self._cdf = cdf / cdf[:, -1:]
        # score of the angle: d/d omega log f (without the Haar factor).
        # Where the truncated series underflows (small sigma, large omega)
        # fall back to the small-sigma Gaussian asymptotic -omega/sigma^2.
        dlogf = np.gradient(np.log(pdf), self._omega, axis=1)
        gauss = -self._omega[None, :] / (self._sigma_grid[:, None] ** 2)
        underflow = pdf <= 1e-11
        self._score_norm = np.where(underflow, gauss, dlogf)
        self._score_scale = np.sqrt(
            np.abs((self._pdf * dlogf**2).sum(1)
                   / self._pdf.sum(1)))  # E[score^2]^0.5 per sigma

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.omega_grid = dev(self._omega)
        self.sigma_grid = dev(self._sigma_grid)
        self.cdf = dev(self._cdf)
        self.score_norm_table = dev(self._score_norm)
        self.score_scale_table = dev(self._score_scale)
        self._exp_min = torch.exp(_f32(min_sigma, device))
        self._exp_max = torch.exp(_f32(max_sigma, device))

    # -- schedule -------------------------------------------------------------

    def sigma(self, t: Tensor) -> Tensor:
        """sigma(t) = log(t e^{max} + (1-t) e^{min}) (reference
        so3_diffuser.py:188-195): monotone from min_sigma to max_sigma."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        return torch.log(t * self._exp_max + (1.0 - t) * self._exp_min)

    def _sigma_idx(self, sigma: Tensor) -> Tensor:
        frac = (sigma - self.min_sigma) / (self.max_sigma - self.min_sigma)
        return torch.clamp((frac * (self.num_sigma - 1)).to(torch.int32), 0,
                           self.num_sigma - 1).long()

    # -- sampling ---------------------------------------------------------------

    def sample_angle(self, generator: Optional[torch.Generator], t,
                     shape: Tuple[int, ...], *,
                     u: Optional[Tensor] = None) -> Tensor:
        """Rotation angles omega ~ IGSO3(sigma(t)) by inverse CDF of
        uniforms `u` (drawn from `generator` when not given). `t` is scalar
        or [B] (broadcast against a (B, ...) shape)."""
        idx = self._sigma_idx(self.sigma(t))
        idx = idx.reshape(idx.shape + (1,) * (len(shape) - idx.ndim)) \
            .expand(shape)
        if u is None:
            u = torch.rand(shape, generator=generator, device=self.device)
        rows = self.cdf[idx.reshape(-1)]                    # [K, O]
        pos = torch.searchsorted(rows, u.reshape(-1, 1).to(rows)) \
            .squeeze(-1)
        pos = torch.clamp(pos, 0, len(self._omega) - 1)
        return self.omega_grid[pos].reshape(shape)

    def sample(self, generator: Optional[torch.Generator], t,
               shape: Tuple[int, ...], *, u: Optional[Tensor] = None,
               axis: Optional[Tensor] = None) -> Tensor:
        """Axis-angle rotation vectors [..., 3] from IGSO3(sigma(t)); `axis`
        ([..., 3] standard normal) and `u` may be handed in."""
        omega = self.sample_angle(generator, t, shape, u=u)
        if axis is None:
            axis = torch.randn(tuple(shape) + (3,), generator=generator,
                               device=self.device)
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        return axis * omega[..., None]

    # -- score ---------------------------------------------------------------------

    def score_norm(self, t, omega: Tensor) -> Tensor:
        """d/d omega log f(omega | sigma(t)), looked up from the grid.
        `t` scalar or [B], `omega` any shape broadcastable from it."""
        idx = self._sigma_idx(self.sigma(t))
        idx = idx.reshape(idx.shape + (1,) * (omega.ndim - idx.ndim)) \
            .expand(omega.shape)
        o_idx = torch.clamp(torch.searchsorted(self.omega_grid,
                                               omega.contiguous()),
                            0, len(self._omega) - 1)
        return self.score_norm_table[idx, o_idx]

    def score(self, t, rotvec: Tensor) -> Tensor:
        """Score in the tangent space: axis * dlogf(|rotvec|)."""
        omega = torch.linalg.norm(rotvec, dim=-1)
        axis = rotvec / torch.clamp(omega, min=1e-8)[..., None]
        return axis * self.score_norm(t, omega)[..., None]

    def score_scaling(self, t) -> Tensor:
        """sqrt(E[score^2]) / sqrt(3), the reference's score_scaling
        (so3_diffuser.py:172-176, :301-303); FrameDiff DIVIDES its rotation
        loss by this value."""
        idx = self._sigma_idx(self.sigma(t))
        return self.score_scale_table[idx] / torch.sqrt(
            _f32(3.0, self.device))

    # -- forward / reverse ------------------------------------------------------------

    def forward_marginal(self, generator: Optional[torch.Generator],
                         rot0: Tensor, t, *, u: Optional[Tensor] = None,
                         axis: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
        """Compose rot0 (rotation matrices [..., 3, 3]) with an IGSO3
        sample; returns (rot_t, sampled rotvec)."""
        rv = self.sample(generator, t, tuple(rot0.shape[:-2]), u=u,
                         axis=axis)
        return rot0 @ rotvec_to_matrix(rv), rv

    def reverse_step(self, generator: Optional[torch.Generator],
                     rot_t: Tensor, score: Tensor, t, dt: float,
                     noise_scale: float = 1.0, *,
                     noise: Optional[Tensor] = None) -> Tensor:
        """Geodesic EM step: rot <- rot exp{drift + noise}, g_t^2 =
        2 sigma sigma' for the logarithmic schedule (reference
        so3_diffuser.py:197-206); `noise` ([..., 3] standard normal) may be
        handed in."""
        s = self.sigma(t)
        g2 = 2.0 * s * (self._exp_max - self._exp_min) / torch.exp(s)
        g2 = g2.reshape(g2.shape + (1,) * (score.ndim - g2.ndim))
        drift = g2 * score * dt
        if noise is None:
            noise = torch.randn(score.shape, generator=generator,
                                device=score.device)
        noise = noise_scale * torch.sqrt(torch.clamp(g2 * dt, min=0.0)) \
            * noise
        return rot_t @ rotvec_to_matrix(drift + noise)


def rotvec_to_matrix(rv: Tensor) -> Tensor:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta = torch.linalg.norm(rv, dim=-1, keepdim=True)
    k = rv / torch.clamp(theta, min=1e-8)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    km = torch.stack([
        torch.stack([zero, -kz, ky], -1),
        torch.stack([kz, zero, -kx], -1),
        torch.stack([-ky, kx, zero], -1)], -2)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(km.shape)
    return eye + torch.sin(theta) * km + (1 - torch.cos(theta)) * (km @ km)


def matrix_to_rotvec(rot: Tensor) -> Tensor:
    """Inverse Rodrigues (log map), stable near 0 and pi."""
    trace = torch.diagonal(rot, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((trace - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    theta = torch.arccos(cos)
    vec = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                       rot[..., 0, 2] - rot[..., 2, 0],
                       rot[..., 1, 0] - rot[..., 0, 1]], -1)
    return vec * (theta / torch.clamp(2 * torch.sin(theta),
                                      min=1e-8))[..., None]
