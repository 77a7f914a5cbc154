"""ODE integrators for flow-matching sampling, in PyTorch.

Counterpart of `tpu_diffusion/sampling/ode.py` (the reference's torchdyn
`NeuralODE` and `torchdiffeq.odeint` dopri5 loops):

  * fixed-step Euler / Midpoint / Heun(2) / RK4 over a time grid; given a
    `sampling/graph.py:GraphCache` (`graphs=`) the step is captured once as
    a CUDA graph and replayed on a CUDA tensor, the grid's times read from
    a device table at the chain's counter (the same bodies in a Python loop
    on a CPU tensor), bitwise equal to the eager loop;
  * adaptive Dormand–Prince 5(4) with FSAL and the 0.9-safety step
    controller of the JAX `_dopri5_body`, as a Python loop with early exit.
    It reads one device scalar per trip (whether t reached t1), the loop's
    only synchronisation, and stops at 6 * max_steps NFE.

Velocity signature: `v(t, x) -> dx/dt` with `t` a 0-d tensor on x's device.
Every integrator returns `(x1, nfe)`, nfe a Python int. The JAX package's
fixed-trip and chunked dopri5 drivers (`Dopri5Chunked`,
`dopri5_platform_kwargs`, `calibrate_dopri5_steps`) exist for a TPU runtime
that cannot run dynamic loops; they have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpu_diffusion_torch.sampling.graph import GraphCache, row_at, scan

VField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _time_grid(num_steps: int, t0: float, t1: float, device) -> torch.Tensor:
    return torch.linspace(t0, t1, num_steps + 1, device=device)


def _euler_step(v: VField, t, tn, x):
    return x + (tn - t) * v(t, x)


def _midpoint_step(v: VField, t, tn, x):
    dt = tn - t
    k1 = v(t, x)
    return x + dt * v(t + dt / 2, x + dt / 2 * k1)


def _heun_step(v: VField, t, tn, x):
    dt = tn - t
    k1 = v(t, x)
    k2 = v(tn, x + dt * k1)
    return x + dt / 2 * (k1 + k2)


def _rk4_step(v: VField, t, tn, x):
    dt = tn - t
    k1 = v(t, x)
    k2 = v(t + dt / 2, x + dt / 2 * k1)
    k3 = v(t + dt / 2, x + dt / 2 * k2)
    k4 = v(t + dt, x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _fixed_step(step, nfe_per_step: int, v: VField, x0: torch.Tensor,
                num_steps: int, t0: float, t1: float,
                graphs: Optional[GraphCache]) -> Tuple[torch.Tensor, int]:
    """`num_steps` steps of `step(v, t_k, t_k+1, x)` over the grid: a Python
    loop, or with `graphs` the graphed chain (t_k and t_k+1 read from the
    grid at the chain's counter)."""
    ts = _time_grid(num_steps, t0, t1, x0.device)
    if graphs is not None:
        def make_step(buf):
            grid, grid_next = ts[:-1].contiguous(), ts[1:].contiguous()

            def body(scratch, x, t, j, sig, noise):
                return step(v, row_at(grid, t), row_at(grid_next, t), x)
            return body

        x = scan(graphs, (step, num_steps, t0, t1), v, x0,
                 [[k] for k in range(num_steps)], make_step)
        return x, nfe_per_step * num_steps
    x = x0
    for k in range(num_steps):
        x = step(v, ts[k], ts[k + 1], x)
    return x, nfe_per_step * num_steps


def odeint_euler(v: VField, x0: torch.Tensor, num_steps: int = 100,
                 t0: float = 0.0, t1: float = 1.0, *,
                 graphs: Optional[GraphCache] = None
                 ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_euler_step, 1, v, x0, num_steps, t0, t1, graphs)


def odeint_midpoint(v: VField, x0: torch.Tensor, num_steps: int = 50,
                    t0: float = 0.0, t1: float = 1.0, *,
                    graphs: Optional[GraphCache] = None
                    ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_midpoint_step, 2, v, x0, num_steps, t0, t1, graphs)


def odeint_heun(v: VField, x0: torch.Tensor, num_steps: int = 50,
                t0: float = 0.0, t1: float = 1.0, *,
                graphs: Optional[GraphCache] = None
                ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_heun_step, 2, v, x0, num_steps, t0, t1, graphs)


def odeint_rk4(v: VField, x0: torch.Tensor, num_steps: int = 25,
               t0: float = 0.0, t1: float = 1.0, *,
               graphs: Optional[GraphCache] = None
               ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_rk4_step, 4, v, x0, num_steps, t0, t1, graphs)


# ---------------------------------------------------------------------------
# Dormand–Prince 5(4), adaptive
# ---------------------------------------------------------------------------

_DP_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_DP_A = [
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_DP_B4 = [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40]


def _dopri5_step(v: VField, t, x, dt, k1):
    """(x5, x4, k7): one Dormand–Prince step of `dt` from (t, x) with the
    slope k1 there; k7 is the slope at (t + dt, x5) (FSAL)."""
    ks = [k1]
    for s in range(1, 7):
        incr = sum(_DP_A[s - 1][j] * ks[j] for j in range(s)
                   if _DP_A[s - 1][j] != 0.0)
        ks.append(v(t + _DP_C[s] * dt, x + dt * incr))
    x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, ks) if b != 0.0)
    x4 = x + dt * sum(b * k for b, k in zip(_DP_B4, ks) if b != 0.0)
    return x5, x4, ks[-1]


def odeint_dopri5(v: VField, x0: torch.Tensor, t0: float = 0.0,
                  t1: float = 1.0, rtol: float = 1e-5, atol: float = 1e-5,
                  max_steps: int = 1000, *, graphs: Optional[GraphCache] = None
                  ) -> Tuple[torch.Tensor, int]:
    """Adaptive RK45 with FSAL: one step size for the whole batch, the RMS
    error norm scaled by atol + rtol * max(|x|, |x_new|), accept at norm
    <= 1, the next step scaled by clip(0.9 * err^-0.2, 0.2, 10). At most
    `max_steps` trips (1 + 6 * trips NFE); `dopri5_truncated` tells a run
    that used them all. Always eager, `graphs` or not: the early exit reads
    the card once a trip (the JAX `lax.while_loop`; a graph of it would
    need conditional nodes)."""
    del graphs
    t = torch.tensor(t0, dtype=torch.float32, device=x0.device)
    dt = torch.tensor((t1 - t0) / 100.0, dtype=torch.float32,
                      device=x0.device)
    x, k1, nfe = x0, v(t, x0), 1
    while nfe < 6 * max_steps:
        dt = torch.minimum(dt, t1 - t)
        x5, x4, k7 = _dopri5_step(v, t, x, dt, k1)
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err = torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2))
        accept = err <= 1.0
        factor = torch.clamp(0.9 * (err + 1e-10) ** -0.2, 0.2, 10.0)
        t = torch.where(accept, t + dt, t)
        x = torch.where(accept, x5, x)
        k1 = torch.where(accept, k7, k1)
        dt = dt * factor
        nfe += 6
        if bool(t >= t1 - 1e-8):  # the loop's one device read
            break
    return x, nfe


def dopri5_truncated(nfe: int, max_steps: int) -> bool:
    """True when a dopri5 run consumed its whole `max_steps` budget: the
    trajectory MAY be unconverged. Conservative: a run that converges on
    its last budgeted trip is flagged too."""
    return nfe >= 6 * max_steps


INTEGRATORS = {
    "euler": odeint_euler,
    "midpoint": odeint_midpoint,
    "heun": odeint_heun,
    "rk4": odeint_rk4,
    "dopri5": odeint_dopri5,
}


def odeint(v: VField, x0: torch.Tensor, method: str = "euler", **kw
           ) -> Tuple[torch.Tensor, int]:
    if method not in INTEGRATORS:
        raise NotImplementedError(
            f"Unknown integrator {method!r}; expected {sorted(INTEGRATORS)}")
    return INTEGRATORS[method](v, x0, **kw)
