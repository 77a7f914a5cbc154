"""ODE integrators for flow-matching sampling, in PyTorch.

Counterpart of `tpu_diffusion/sampling/ode.py` (the reference's torchdyn
`NeuralODE` and `torchdiffeq.odeint` dopri5 loops):

  * fixed-step Euler / Midpoint / Heun(2) / RK4 over a time grid, linspace
    from t0 to t1 or a given one (`grid=`: FLUX's shifted sigmas,
    `shifted_sigmas`, from 1 down to 0); given a
    `sampling/graph.py:GraphCache` (`graphs=`) the step is captured once as
    a CUDA graph and replayed on a CUDA tensor, the grid's times read from
    a device table at the chain's counter (the same bodies in a Python loop
    on a CPU tensor), bitwise equal to the eager loop;
  * adaptive Dormand–Prince 5(4) with FSAL and the 0.9-safety step
    controller of the JAX `_dopri5_body`: the early-exit loop (which reads
    one device scalar a trip, whether t reached t1, and stops after
    `max_steps` trips), the fixed-trip-count masked scan and the chunked
    integrator `Dopri5Chunked`, with `dopri5_platform_kwargs` and
    `calibrate_dopri5_steps`. Given `graphs`, the early exit replays a
    captured one-trip body and reads `done` on the host after each replay,
    as the eager loop reads it after each trip (`_graphed_dopri5`).

Velocity signature: `v(t, x) -> dx/dt` with `t` a 0-d tensor on x's device
(`amortized_velocity` concatenates a condition to x first). Every
integrator returns `(x1, nfe)`, nfe a Python int.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpu_diffusion_torch.sampling.graph import GraphCache, row_at, scan

VField = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _time_grid(num_steps: int, t0: float, t1: float, device) -> torch.Tensor:
    return torch.linspace(t0, t1, num_steps + 1, device=device)


def shifted_sigmas(num_steps: int, image_tokens: int, *,
                   base_image_seq_len: int, max_image_seq_len: int,
                   base_shift: float, max_shift: float) -> torch.Tensor:
    """The sigma grid of diffusers' `FlowMatchEulerDiscreteScheduler` with
    dynamic shifting, as FLUX's pipelines set it (float64, num_steps + 1
    values from 1 down to 0): s = linspace(1, 1/num_steps, num_steps),
    shifted to e^mu / (e^mu + 1/s - 1) with mu linear in the image's token
    count between (base_image_seq_len, base_shift) and (max_image_seq_len,
    max_shift), then 0 appended. The keywords are the scheduler config's."""
    m = (max_shift - base_shift) / (max_image_seq_len - base_image_seq_len)
    e = math.exp(base_shift + m * (image_tokens - base_image_seq_len))
    # diffusers' np.linspace: torch.linspace's float64 values differ from
    # it in the last bit
    s = torch.from_numpy(np.linspace(1.0, 1.0 / num_steps, num_steps))
    return torch.cat([e / (e + (1.0 / s - 1.0)), s.new_zeros(1)])


def amortized_velocity(v: VField, condition: torch.Tensor) -> VField:
    """`sampling/ancestral.py:amortized_eps_fn`'s rule for a velocity:
    the condition concatenated to x as extra channels (last axis) before
    the model. `condition` is read at each call, so a caller may overwrite
    it in place between chains."""
    def fn(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return v(t, torch.cat([x, condition], dim=-1))
    return fn


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
                graphs: Optional[GraphCache],
                grid=None) -> Tuple[torch.Tensor, int]:
    """`num_steps` steps of `step(v, t_k, t_k+1, x)` over the grid (linspace
    from t0 to t1, or `grid`'s len(grid) - 1 steps): a Python loop, or with
    `graphs` the graphed chain (t_k and t_k+1 read at the chain's counter
    from the grid, one of the chain's inputs, copied in before each chain:
    one capture serves every grid of its length)."""
    ts = (_time_grid(num_steps, t0, t1, x0.device) if grid is None else
          torch.as_tensor(grid, dtype=torch.float32, device=x0.device))
    num_steps = ts.numel() - 1
    if graphs is not None:
        def make_step(buf):
            def body(scratch, x, t, j, sig, noise):
                return step(v, row_at(buf["grid"], t),
                            row_at(buf["grid_next"], t), x)
            return body

        x = scan(graphs, (step, num_steps), v, x0,
                 [[k] for k in range(num_steps)], make_step,
                 inputs={"grid": ts[:-1], "grid_next": ts[1:]})
        return x, nfe_per_step * num_steps
    x = x0
    for k in range(num_steps):
        x = step(v, ts[k], ts[k + 1], x)
    return x, nfe_per_step * num_steps


def odeint_euler(v: VField, x0: torch.Tensor, num_steps: int = 100,
                 t0: float = 0.0, t1: float = 1.0, *,
                 graphs: Optional[GraphCache] = None, grid=None
                 ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_euler_step, 1, v, x0, num_steps, t0, t1, graphs,
                       grid)


def odeint_midpoint(v: VField, x0: torch.Tensor, num_steps: int = 50,
                    t0: float = 0.0, t1: float = 1.0, *,
                    graphs: Optional[GraphCache] = None, grid=None
                    ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_midpoint_step, 2, v, x0, num_steps, t0, t1, graphs,
                       grid)


def odeint_heun(v: VField, x0: torch.Tensor, num_steps: int = 50,
                t0: float = 0.0, t1: float = 1.0, *,
                graphs: Optional[GraphCache] = None, grid=None
                ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_heun_step, 2, v, x0, num_steps, t0, t1, graphs,
                       grid)


def odeint_rk4(v: VField, x0: torch.Tensor, num_steps: int = 25,
               t0: float = 0.0, t1: float = 1.0, *,
               graphs: Optional[GraphCache] = None, grid=None
               ) -> Tuple[torch.Tensor, int]:
    return _fixed_step(_rk4_step, 4, v, x0, num_steps, t0, t1, graphs,
                       grid)


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


_STATE = ("t", "x", "dt", "k1", "nfe", "done")


def _dopri5_body(v: VField, t1: float, rtol: float, atol: float):
    """One accepted-or-rejected Dormand–Prince trip on the state
    `(t, x, dt, k1, nfe, done)`: one step size for the whole batch, the RMS
    error norm scaled by atol + rtol * max(|x|, |x_new|), accept at norm
    <= 1, the next step scaled by clip(0.9 * err^-0.2, 0.2, 10). Every
    scalar is a 0-d tensor on x's device (nfe int32), so a trip reads
    nothing on the host; the early-exit loop, the masked scan, the chunked
    integrator and the graphed chains share it, as the JAX integrators
    share theirs."""

    def body(state):
        t, x, dt, k1, nfe, done = state
        dt = torch.minimum(dt, t1 - t)
        x5, x4, k7 = _dopri5_step(v, t, x, dt, k1)
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err = torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2))
        accept = err <= 1.0
        factor = torch.clamp(0.9 * (err + 1e-10) ** -0.2, 0.2, 10.0)
        t = torch.where(accept, t + dt, t)
        x = torch.where(accept, x5, x)
        k1 = torch.where(accept, k7, k1)
        return (t, x, dt * factor, k1, nfe + 6, t >= t1 - 1e-8)

    return body


def _dopri5_init(v: VField, x0: torch.Tensor, t0: float, t1: float):
    """The state before the first trip: k1 = v(t0, x0), one NFE."""
    t = torch.tensor(t0, dtype=torch.float32, device=x0.device)
    return (t, x0, torch.tensor((t1 - t0) / 100.0, dtype=torch.float32,
                                device=x0.device), v(t, x0),
            torch.tensor(1, dtype=torch.int32, device=x0.device),
            torch.tensor(False, device=x0.device))


def _dopri5_masked_scan_body(body):
    """A trip that leaves a finished state as it is, nfe included."""
    def scan_body(state):
        done = state[5]
        return tuple(torch.where(done, a, b)
                     for a, b in zip(state, body(state)))
    return scan_body


def _dopri5_chain(graphs: GraphCache, slot, v: VField, x0: torch.Tensor,
                  t0: float, t1: float, rtol: float, atol: float, trips):
    """The dopri5 chain of `graphs` for x0's shape: static buffers for the
    state and the input, a body "init" (the state from the input) and one
    body of n masked trips for each n in `trips`."""
    def build():
        buf = {"t": torch.zeros((), device=x0.device),
               "x": torch.zeros_like(x0),
               "dt": torch.zeros((), device=x0.device),
               "k1": torch.zeros_like(x0),
               "nfe": torch.zeros((), dtype=torch.int32, device=x0.device),
               "done": torch.zeros((), dtype=torch.bool, device=x0.device)}
        trip = _dopri5_masked_scan_body(_dopri5_body(v, t1, rtol, atol))

        def init():
            # fills, not new tensors: a capture takes no host-to-device copy
            buf["t"].fill_(t0)
            buf["dt"].fill_((t1 - t0) / 100.0)
            buf["nfe"].fill_(1)
            buf["done"].fill_(False)
            buf["k1"].copy_(v(buf["t"], buf["x"]))

        def run(n):
            def body():
                state = tuple(buf[k] for k in _STATE)
                for _ in range(n):
                    state = trip(state)
                for k, value in zip(_STATE, state):
                    buf[k].copy_(value)
            return body

        return buf, {"init": init, **{n: run(n) for n in trips}}

    chain = graphs.chain((slot, tuple(x0.shape), x0.dtype, str(x0.device),
                          t0, t1, rtol, atol, tuple(trips)), v, build)
    chain.buffers["x"].copy_(x0)
    chain.replay("init")
    return chain


def _graphed_dopri5(v: VField, x0: torch.Tensor, t0: float, t1: float,
                    rtol: float, atol: float, max_steps: int,
                    fixed_trip_count: bool, graphs: GraphCache
                    ) -> Tuple[torch.Tensor, int]:
    """`max_steps` replays of a one-trip masked body. Unless
    `fixed_trip_count`, the host reads `done` after each replay and the
    chain ends at the first: x and nfe are the early-exit loop's. (A body
    of several trips, or letting the card run a body past the last read,
    ran slower on the card: PERF.md.)"""
    chain = _dopri5_chain(graphs, "dopri5", v, x0, t0, t1, rtol, atol, (1,))
    for _ in range(max_steps):
        chain.replay(1)
        if not fixed_trip_count and bool(chain.buffers["done"]):
            break
    buf = chain.buffers
    return buf["x"].clone(), int(buf["nfe"])


def odeint_dopri5(v: VField, x0: torch.Tensor, t0: float = 0.0,
                  t1: float = 1.0, rtol: float = 1e-5, atol: float = 1e-5,
                  max_steps: int = 1000, fixed_trip_count: bool = False, *,
                  graphs: Optional[GraphCache] = None
                  ) -> Tuple[torch.Tensor, int]:
    """Adaptive RK45 with FSAL and the 0.9-safety step controller of
    `_dopri5_body`, at most `max_steps` trips (1 + 6 * trips NFE);
    `dopri5_truncated` tells a run that used them all.

    By default the early-exit loop, which reads `done` on the host after
    every trip. `fixed_trip_count=True` runs exactly `max_steps` masked
    trips with no host read before the end, equal to the early exit in x
    and nfe (the JAX package's mode for a TPU runtime that hangs on
    dynamic loops). With `graphs`, either as a graphed chain
    (`_graphed_dopri5`; on a CPU tensor its bodies in a loop), x bitwise
    and nfe the eager loop's."""
    if graphs is not None:
        return _graphed_dopri5(v, x0, t0, t1, rtol, atol, max_steps,
                               fixed_trip_count, graphs)
    body = _dopri5_body(v, t1, rtol, atol)
    state = _dopri5_init(v, x0, t0, t1)
    if fixed_trip_count:
        trip = _dopri5_masked_scan_body(body)
        for _ in range(max_steps):
            state = trip(state)
    else:
        for _ in range(max_steps):
            state = body(state)
            if bool(state[5]):  # the loop's one device read a trip
                break
    return state[1], int(state[4])


class Dopri5Chunked:
    """Fixed-trip-count dopri5 in segments of `chunk_steps` masked trips,
    bitwise equal to one masked scan of `n_segments * chunk_steps` trips
    (`max_steps` rounded up to whole segments: a trajectory unconverged at
    the requested budget gets up to `chunk_steps - 1` trips more). Every
    segment runs, as in the JAX package; the masked trip freezes a
    finished state, so where the segments end cannot change the result.

    On a CUDA tensor a segment is one replay of a captured body of
    `chunk_steps` trips (`sampling/graph.py`), in `graphs` when given or
    else in a `GraphCache(v)` of its own; a cache that follows the field's
    module recaptures after its parameters change. On a CPU tensor the
    same bodies run in a loop. `sync=True` reads the state's time on the
    host after each segment, as the JAX integrator does.

        sampler = Dopri5Chunked(velocity, max_steps=92, chunk_steps=16)
        x1, nfe = sampler(noise)
    """

    def __init__(self, v: VField, t0: float = 0.0, t1: float = 1.0,
                 rtol: float = 1e-5, atol: float = 1e-5,
                 max_steps: int = 128, chunk_steps: int = 16, *,
                 graphs: Optional[GraphCache] = None):
        self.n_segments = -(-max_steps // chunk_steps)
        self.chunk_steps = chunk_steps
        # rounded up to whole segments; >= the requested budget
        self.total_steps = self.n_segments * chunk_steps
        self._args = (v, t0, t1, rtol, atol)
        self.graphs = graphs if graphs is not None else GraphCache(v)

    def __call__(self, x0: torch.Tensor, sync: bool = True
                 ) -> Tuple[torch.Tensor, int]:
        v, t0, t1, rtol, atol = self._args
        chain = _dopri5_chain(self.graphs, "dopri5_chunked", v, x0, t0, t1,
                              rtol, atol, (self.chunk_steps,))
        for _ in range(self.n_segments):
            chain.replay(self.chunk_steps)
            if sync:
                float(chain.buffers["t"])
        buf = chain.buffers
        return buf["x"].clone(), int(buf["nfe"])


def dopri5_platform_kwargs(max_steps_fixed: int = 128) -> dict:
    """The dopri5 arguments for the platform: the JAX package's
    fixed-trip-count masked scan on a TPU, the early exit elsewhere. The
    port runs on no TPU, so always the early exit: {}."""
    del max_steps_fixed
    return {}


def dopri5_truncated(nfe: int, max_steps: int) -> bool:
    """True when a dopri5 run consumed its whole `max_steps` budget: the
    trajectory MAY be unconverged. Conservative: a run that converges on
    its last budgeted trip is flagged too."""
    return nfe >= 6 * max_steps


def calibrate_dopri5_steps(v: VField, x0: torch.Tensor,
                           rtol: float = 1e-5, atol: float = 1e-5,
                           t0: float = 0.0, t1: float = 1.0,
                           margin: float = 1.5, min_steps: int = 16,
                           max_steps: int = 2000) -> int:
    """A fixed-trip `max_steps` budget for `x0`'s field: the early-exit
    controller's trips in one run, times `margin`, at least `min_steps`.
    The probe runs where x0 lives (the JAX package runs it on the host CPU
    because its TPU runtime hangs on dynamic loops)."""
    _, nfe = odeint_dopri5(v, x0, t0=t0, t1=t1, rtol=rtol, atol=atol,
                           max_steps=max_steps)
    return max(min_steps, math.ceil((nfe // 6 + 1) * margin))


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
