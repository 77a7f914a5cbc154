"""Graph diffusion processes over padded dense protein batches.

Counterpart of `tpu_diffusion/protein/sde.py`: a protein batch is (pos
[B, N, 3], mask [B, N]); the noise is centre-of-mass free per graph (a
masked projection); the Hoogeboom polynomial schedule alpha_bar(t) =
(1 - t^e)^2 (1 - 2s) + s with beta(t) = -d/dt log alpha_bar(t) in closed
form, clipped at 0.25; the VP mirror with a linear beta.

The tables (`ts`, `alphas_cumprod`, `discrete_betas`, `alphas`) are fp32,
as jnp makes them, on the SDE's device. The reverse chain is a Python loop
over steps num_steps-1 ... 0 that reads its coefficients from those fp32
tables on the device (no host read), in the JAX package's order: eps_hat
from the positions before the conditioner's update, then the DDPM step with
that eps_hat on the updated positions. Given a
`sampling/graph.py:GraphCache` (`graphs=`), the unguided chain runs
graphed: its step captured once as a CUDA graph and replayed on a CUDA
tensor (the same body in a Python loop on the CPU), the coefficients read
at the chain's counter, each step's COM-free noise drawn before its replay
as the eager loop draws it; bitwise equal to the eager loop. The guided
chain stays eager: the conditioner's `torch.linalg.svd` synchronises with
the host, which a capture refuses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import torch

from tpu_diffusion_torch.protein.geometry import center, masked_mean
from tpu_diffusion_torch.sampling.graph import (GraphCache, row_at, rows_at,
                                                scan)

Tensor = torch.Tensor


class ProteinBatch(NamedTuple):
    """Padded dense graph batch."""

    pos: Tensor           # [B, N, 3]
    mask: Tensor          # [B, N] bool
    node_order: Tensor    # [B, N] int32 chain positions

    @property
    def num_graphs(self) -> int:
        return self.pos.shape[0]

    @classmethod
    def from_positions(cls, pos: Tensor, mask: Optional[Tensor] = None
                       ) -> "ProteinBatch":
        b, n, _ = pos.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=pos.device)
        order = torch.arange(n, dtype=torch.int32,
                             device=pos.device).expand(b, n)
        return cls(pos=pos, mask=mask, node_order=order)


def com_free_noise(generator: Optional[torch.Generator], pos: Tensor,
                   mask: Tensor) -> Tensor:
    """White noise with the masked center of mass removed per graph."""
    z = torch.randn(pos.shape, generator=generator, dtype=pos.dtype,
                    device=pos.device)
    z = z - masked_mean(z, mask, axis=-2)
    return z * mask[..., None].to(pos.dtype)


@dataclass
class HoogeboomGraphSDE:
    """Polynomial alpha_bar schedule + COM-free graph DDPM."""

    num_steps: int = 250
    s: float = 1e-5
    clip_value: float = 0.25
    exponent: int = 2
    device: Optional[torch.device] = None
    ts: Tensor = field(init=False, repr=False)
    alphas_cumprod: Tensor = field(init=False, repr=False)
    discrete_betas: Tensor = field(init=False, repr=False)
    alphas: Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.ts = torch.linspace(0.0, 1.0, self.num_steps,
                                 dtype=torch.float32, device=self.device)
        self.alphas_cumprod = self.alphas_cumprod_fn(self.ts)
        self.discrete_betas = torch.clamp(
            self.beta_fn(self.ts) / self.num_steps, max=self.clip_value)
        self.alphas = 1.0 - self.discrete_betas
        # the reverse step's coefficients, per step, in fp32 as jnp
        # evaluates them
        self._eps_coef = ((1 - self.alphas)
                          / torch.sqrt(1 - self.alphas_cumprod))
        self._sqrt_alphas = torch.sqrt(self.alphas)
        self._sigmas = torch.sqrt(1 - self.alphas)

    # -- continuous schedule ------------------------------------------------

    def alphas_cumprod_fn(self, t: Tensor) -> Tensor:
        return (1.0 - t**self.exponent) ** 2 * (1 - 2 * self.s) + self.s

    def beta_fn(self, t: Tensor) -> Tensor:
        """-d/dt log alpha_bar, closed form."""
        e = self.exponent
        abar = self.alphas_cumprod_fn(t)
        dabar = -2.0 * (1.0 - t**e) * e * t ** (e - 1) * (1 - 2 * self.s)
        return -dabar / abar

    # -- forward -------------------------------------------------------------

    def marginal_prob(self, t: Tensor):
        abar = self.alphas_cumprod_fn(t)
        return torch.sqrt(abar), torch.sqrt(1.0 - abar)

    def noising(self, generator: Optional[torch.Generator],
                batch: ProteinBatch, t: Tensor,
                eps: Optional[Tensor] = None):
        """q(x_t | x_0) with COM-free noise; t: [B]. Returns (noised batch,
        eps); `eps` may be passed instead of drawn."""
        mean_s, std_s = self.marginal_prob(t)
        if eps is None:
            eps = com_free_noise(generator, batch.pos, batch.mask)
        pos = mean_s[:, None, None] * batch.pos + std_s[:, None, None] * eps
        return batch._replace(pos=pos * batch.mask[..., None]), eps

    def denoising(self, batch: ProteinBatch, eps: Tensor, t: Tensor
                  ) -> ProteinBatch:
        """x0_hat = (x_t - sigma eps) / mu (total denoise)."""
        mean_s, std_s = self.marginal_prob(t)
        pos = (batch.pos - std_s[:, None, None] * eps) / mean_s[:, None, None]
        return batch._replace(pos=pos * batch.mask[..., None])

    # -- prior ----------------------------------------------------------------

    def sample_blob(self, generator: Optional[torch.Generator],
                    num_samples: int, num_atoms: int,
                    lengths: Optional[Tensor] = None) -> ProteinBatch:
        """COM-centered Gaussian blob prior on the SDE's device. `lengths`
        ([B]) masks ragged proteins inside the fixed [B, N] canvas."""
        if lengths is None:
            mask = torch.ones((num_samples, num_atoms), dtype=torch.bool,
                              device=self.device)
        else:
            col = torch.arange(num_atoms, device=self.device)
            mask = col[None, :] < torch.as_tensor(
                lengths, device=self.device)[:, None]
        pos = torch.randn((num_samples, num_atoms, 3), generator=generator,
                          device=self.device)
        pos = center(pos, mask) * mask[..., None]
        return ProteinBatch.from_positions(pos, mask)

    # -- reverse --------------------------------------------------------------

    def reverse_diffusion_sampling(
            self, generator: Optional[torch.Generator], batch: ProteinBatch,
            score_model: Callable[[ProteinBatch, Tensor], Tensor],
            conditioner=None, cond_start_step: int = 125,
            no_noise_steps: int = 3, save_trajectory: bool = False, *,
            graphs: Optional[GraphCache] = None):
        """The ancestral reverse chain over steps num_steps-1 ... 0.

        score_model(batch, t_normalized[B]) -> eps_hat [B, N, 3]. The
        conditioner acts for step < cond_start_step; there its forward (with
        a graph to the positions) also gives the step's eps_hat, which is
        the plain forward of the same positions and t. The last
        `no_noise_steps` steps add no noise, though every step draws it.
        Returns the final batch, or ([steps, B, N, 3] trajectory, batch).
        With `graphs` and no conditioner, the graphed chain (no trajectory).
        """
        if graphs is not None and conditioner is None:
            if save_trajectory:
                raise ValueError("the graphed chain keeps no trajectory")
            return self._graphed_reverse(graphs, generator, batch,
                                         score_model, no_noise_steps)
        b = batch.num_graphs
        pos = batch.pos
        mask = batch.mask[..., None].to(pos.dtype)
        traj = []
        for step in range(self.num_steps - 1, -1, -1):
            cur = batch._replace(pos=pos)
            if conditioner is not None and step < cond_start_step:
                update, eps_hat = conditioner.guide(cur, score_model, step,
                                                    self)
                pos = pos + update
            else:
                t = torch.full((b,), float(step), dtype=pos.dtype,
                               device=pos.device) / self.num_steps
                with torch.no_grad():
                    eps_hat = score_model(cur, t)
            z = com_free_noise(generator, pos, batch.mask)
            pos = (pos - self._eps_coef[step] * eps_hat) \
                / self._sqrt_alphas[step]
            if step > no_noise_steps - 1:
                pos = pos + self._sigmas[step] * z
            pos = pos * mask
            if save_trajectory:
                traj.append(pos)
        result = batch._replace(pos=pos)
        if save_trajectory:
            return torch.stack(traj), result
        return result

    @torch.no_grad()
    def _graphed_reverse(self, graphs: GraphCache, generator, batch,
                         score_model, no_noise_steps: int) -> ProteinBatch:
        """The unguided reverse chain through `graph.scan`."""
        n = self.num_steps

        def make_step(buf):
            pos = batch.pos
            steps = torch.arange(n - 1, -1, -1, device=pos.device)
            t_of = (steps.to(pos.dtype) / n).contiguous()
            eps_coef = self._eps_coef.flip(0).contiguous()
            sqrt_alphas = self._sqrt_alphas.flip(0).contiguous()
            sigmas = self._sigmas.flip(0).contiguous()

            def step(scratch, x, k, j, noisy, noise):
                cur = ProteinBatch(pos=x, mask=buf["mask"],
                                   node_order=buf["node_order"])
                eps_hat = score_model(cur, rows_at(t_of, k, x.shape[0]))
                x = (x - row_at(eps_coef, k) * eps_hat) / row_at(
                    sqrt_alphas, k)
                if noisy:
                    x = x + row_at(sigmas, k) * noise[0]
                return x * buf["mask"][..., None].to(x.dtype)

            return step

        def draw(like, kind, step, j):
            return com_free_noise(generator, like, batch.mask)

        pos = scan(graphs, ("reverse", n, no_noise_steps), score_model,
                   batch.pos, [[s] for s in range(n - 1, -1, -1)], make_step,
                   inputs={"mask": batch.mask,
                           "node_order": batch.node_order},
                   sig_of=lambda s: s > no_noise_steps - 1,
                   draws_of=lambda noisy: (("com_free", 0, "x"),), draw=draw)
        return batch._replace(pos=pos)


@dataclass
class VPGraphSDE(HoogeboomGraphSDE):
    """Linear-beta VP mirror: alpha_bar = exp(-int beta)."""

    beta_min: float = 0.1
    beta_max: float = 20.0

    def alphas_cumprod_fn(self, t: Tensor) -> Tensor:
        ib = self.beta_min * t + (self.beta_max - self.beta_min) * t**2 / 2
        return torch.exp(-ib)

    def beta_fn(self, t: Tensor) -> Tensor:
        return self.beta_min + (self.beta_max - self.beta_min) * t
