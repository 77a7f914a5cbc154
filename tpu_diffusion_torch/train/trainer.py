"""The training loop, in PyTorch.

Counterpart of `tpu_diffusion/train/trainer.py`: `make_optimizer` (Adam with
the JAX package's three learning-rate schedules and global-norm clipping),
`make_train_step` (loss, gradients, update, EMA), the train state, and
`Trainer.fit`, whose host loop feeds batches and fires periodic callbacks.
The model's parameters are fp32 whatever the forward's type
(`models/nn.py:CastConv2d`), so Adam and the EMA run on fp32 values as in
the JAX package. The state is updated in place. `Trainer.fit_scanned`
trains from a device-resident batch sampler (`data/device_cache.py`) and
reads the metrics once per chunk.

With a mesh (`parallel/mesh.py`) every rank runs the Trainer: each feeds
its slice of the global batch, the gradients are averaged over "data", and
the reported loss is the global batch's. With `tensor_parallel` and a
"model" axis of more than one rank, the parameters, the EMA and the Adam
moments are laid out by `parallel/tp.py:state_shardings` (each rank holds
its slice; modules gather the full weight at use).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_diffusion_torch.core.ema import EMAState, ema_update
from tpu_diffusion_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                               make_mesh, replicate,
                                               shard_batch)
from tpu_diffusion_torch.parallel.tp import SHARD_ATTR, shard_state_
from tpu_diffusion_torch.train.actions import PeriodicAction

# loss(model, generator, batch) -> scalar
LossFn = Callable[[nn.Module, Optional[torch.Generator], torch.Tensor],
                  torch.Tensor]


def make_schedule(lr: float, warmup: int = 0,
                  total_steps: Optional[int] = None,
                  schedule: str = "warmup") -> Callable[[int], float]:
    """step (0 for the first update) -> learning rate.

    "warmup": lr * min((step + 1) / warmup, 1). "warmup_cosine": linear from
    0 to lr over `warmup` steps, then half a cosine down to 0 at
    max(total_steps, warmup + 1); with warmup=0 it starts at lr and still
    decays. "constant", or "warmup" with warmup=0: lr.
    """
    if schedule == "warmup_cosine":
        if total_steps is None:
            raise ValueError("warmup_cosine needs total_steps")
        decay_steps = max(total_steps, warmup + 1) - warmup

        def sched(step: int) -> float:
            if step < warmup:
                return lr * step / warmup
            c = min(step - warmup, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return sched
    if schedule == "constant" or warmup == 0:
        return lambda step: lr
    return lambda step: lr * min((step + 1) / max(warmup, 1), 1.0)


def global_norm(params: List[torch.Tensor]) -> torch.Tensor:
    """The global norm of the full gradients of `params`, fp32, on the
    device: the squares of sharded gradients' slices (`parallel/tp.py`)
    summed over their "model" group, each replicated gradient counted
    once."""
    sq = torch.stack(torch._foreach_norm([p.grad for p in params])
                     ).float().square()
    sharded = [hasattr(p, SHARD_ATTR) for p in params]
    if not any(sharded):
        return sq.sum().sqrt()
    mask = torch.tensor(sharded, device=sq.device)
    part = sq[mask].sum()
    dist.all_reduce(part, group=getattr(
        params[sharded.index(True)], SHARD_ATTR).group)
    return (part + sq[~mask].sum()).sqrt()


def average_over(tensors: List[torch.Tensor], group, size: int) -> None:
    """Each tensor replaced, in place, by its mean over the ranks of
    `group`, through one all-reduce of a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= size
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) behind a schedule, after clipping
    the gradients to a global norm: scaled by clip / max(norm, clip), the
    JAX package's rule (`torch.nn.utils.clip_grad_norm_` divides by
    norm + 1e-6 instead)."""

    def __init__(self, params, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = 1.0,
                 mesh: Optional[Mesh] = None):
        self.params = [p for p in params]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.mesh = mesh
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.count = 0  # updates made so far

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the gradients'
        global norm before clipping. With a mesh of ranks, the gradients
        are first averaged over its "data" axis."""
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.mesh is not None and self.mesh.device_mesh is not None:
            average_over(grads, self.mesh.group(DATA_AXIS),
                         self.mesh.shape[DATA_AXIS])
        gnorm = global_norm(params)
        if self.grad_clip is not None:
            torch._foreach_mul_(
                grads, self.grad_clip / torch.clamp(gnorm,
                                                    min=self.grad_clip))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return gnorm


def make_optimizer(params, lr: float, warmup: int = 0,
                   grad_clip: Optional[float] = 1.0,
                   total_steps: Optional[int] = None,
                   schedule: str = "warmup",
                   mesh: Optional[Mesh] = None) -> Optimizer:
    """Adam + warmup (+ optional cosine decay) + global-norm clipping over
    `params` (an iterable of parameters). With the `mesh` of a process
    group, the gradients are averaged over its "data" axis first; the
    Trainer takes the same mesh."""
    return Optimizer(params, make_schedule(lr, warmup, total_steps, schedule),
                     grad_clip, mesh)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema: EMAState
    generator: Optional[torch.Generator]

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer,
               generator: Optional[torch.Generator] = None) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer,
                   ema=EMAState.create(dict(model.named_parameters())),
                   generator=generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def make_train_step(loss_fn: LossFn, ema_decay: float = 0.9999,
                    ema_update_every: int = 1, ema_update_after: int = 0,
                    ema_warmup: bool = True) -> Callable:
    """train_step(state, batch) -> (state, {"loss", "grad_norm"}), the
    metrics as tensors on the device; `grad_norm` is taken before
    clipping."""

    def train_step(state: TrainState, batch: torch.Tensor):
        state.model.train()
        state.optimizer.zero_grad()
        loss = loss_fn(state.model, state.generator, batch)
        loss.backward()
        gnorm = state.optimizer.step()
        ema_update(state.ema, state.params, ema_decay,
                   update_every=ema_update_every,
                   update_after=ema_update_after, warmup=ema_warmup)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


class Trainer:
    """fit() = feed batches to the step + fire periodic callbacks.

    Callbacks receive (step, state=..., metrics=...), as `PeriodicCallback`
    expects. `batches` yields global batches: numpy arrays or tensors,
    tuples of them (the (x0, x1) pairs of `losses.cfm.host_ot_pairs`) or
    dicts of them (the {"x", "y"} batches of
    `cli/train_conditional_mnist.py`); each rank keeps its "data" slice and
    moves it to the model's device.

    `mesh` (default: the optimizer's, else `make_mesh()`, every rank on
    "data"): with a process group, the state is broadcast from the first
    rank, the optimizer (built with the same mesh) averages the gradients
    over "data", and the loss is averaged over "data"; each "data" rank
    draws its own noise for its slice (its generator re-seeded by its
    index; index 0 keeps the seed), where the JAX step draws the global
    batch's with one key (ROADMAP §C). `tensor_parallel` with a
    "model" axis > 1 shards the state (`parallel/tp.py:shard_state_`).
    """

    def __init__(self, train_step: Callable, state: TrainState,
                 batches: Iterator, mesh: Optional[Mesh] = None,
                 callbacks: Optional[List[Callable]] = None,
                 tensor_parallel: bool = False):
        if mesh is None:
            mesh = state.optimizer.mesh or make_mesh()
        self.mesh = mesh
        self.state = state
        self.callbacks = callbacks or []
        self._step_fn = train_step
        self._batches = batches
        self._device = next(state.model.parameters()).device
        self.n_sharded = 0
        if self.mesh.device_mesh is not None:
            with torch.no_grad():
                replicate(self.mesh, (list(state.model.parameters()),
                                      list(state.ema.params.values())))
            if state.optimizer.mesh is not self.mesh:
                raise ValueError(
                    "the optimizer averages the gradients over its own "
                    "mesh: build it with make_optimizer(..., mesh=) of "
                    "the Trainer's mesh")
            index = self.mesh.index(DATA_AXIS)
            if index and state.generator is not None:
                # an odd 64-bit step: the seed's low 32 bits differ too,
                # the only ones the CPU generator reads
                state.generator.manual_seed(
                    (state.generator.initial_seed()
                     + index * 0x9E3779B97F4A7C15) % 2**64)
        if tensor_parallel and self.mesh.shape[MODEL_AXIS] > 1:
            self.n_sharded = shard_state_(self.mesh, state)

    def _global_metrics(self, metrics: Dict) -> Dict:
        """The loss averaged over the "data" ranks."""
        if self.mesh.device_mesh is None:
            return metrics
        loss = metrics["loss"].float().clone()
        dist.all_reduce(loss, group=self.mesh.group(DATA_AXIS))
        return {**metrics, "loss": loss / self.mesh.shape[DATA_AXIS]}

    def fit(self, num_steps: int,
            metrics_hook: Optional[Callable[[int, Dict], None]] = None
            ) -> TrainState:
        t0 = time.monotonic()
        step0 = self.state.step
        for local_step in range(num_steps):
            batch = shard_batch(self.mesh, next(self._batches))
            if isinstance(batch, tuple):
                batch = tuple(torch.as_tensor(b).to(self._device)
                              for b in batch)
            elif isinstance(batch, dict):
                batch = {k: torch.as_tensor(b).to(self._device)
                         for k, b in batch.items()}
            else:
                batch = torch.as_tensor(batch).to(self._device)
            self.state, metrics = self._step_fn(self.state, batch)
            metrics = self._global_metrics(metrics)
            step = step0 + local_step + 1
            # The metrics come to the host (a device synchronisation) only
            # on steps where some consumer runs. Each callback's decision is
            # sampled once and passed back in: an every_secs deadline
            # crossing between this preview and the callback's own re-check
            # would otherwise fire with the device tensors.
            decisions = [getattr(cb, "should_fire", lambda s: True)(step)
                         for cb in self.callbacks]
            if metrics_hook is not None or any(decisions):
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = (local_step + 1) / (
                    time.monotonic() - t0)
            else:
                m = metrics  # device tensors; no callback will read them
            if metrics_hook is not None:
                metrics_hook(step, m)
            for cb, d in zip(self.callbacks, decisions):
                if hasattr(cb, "should_fire"):
                    cb(step, state=self.state, metrics=m, _fire=d)
                else:
                    cb(step, state=self.state, metrics=m)
        return self.state

    def fit_scanned(self, num_steps: int,
                    sample_batch: Callable[[torch.Generator], object],
                    chunk: int = 100, base_seed: int = 0,
                    metrics_hook: Optional[Callable[[int, Dict], None]]
                    = None) -> TrainState:
        """Train from an on-device batch sampler, `chunk` steps between
        host reads.

        The batch of global step s is `sample_batch(generator)` with a
        generator on the model's device seeded by `step_seed(base_seed,
        s)`, so the stream depends on neither `chunk` nor where a run
        resumed; with a mesh, `sample_batch` returns this rank's slice of
        the global batch (`data/device_cache.py` samplers built with the
        mesh draw the global batch and keep the slice). Inside a chunk
        nothing is read on the host: the losses and gradient norms gather
        into device tensors, read once at its end
        (which also bounds how far the host runs ahead). Callbacks and the
        hook fire once per chunk with `loss`, `grad_norm` (the last
        step's), `loss_mean`, `steps_per_sec` and the whole
        `loss_trace`/`grad_norm_trace`; a `PeriodicAction`, which must be
        called every step, raises.
        """
        for cb in self.callbacks:
            if isinstance(cb, PeriodicAction):
                raise ValueError(
                    "fit_scanned() fires callbacks once per chunk, which "
                    "violates PeriodicAction's call-every-step contract - "
                    "use the metrics_hook (it receives the full per-step "
                    "loss_trace) or fit() for per-step cadence")
        step0 = self.state.step
        t0 = time.monotonic()
        done = 0
        while done < num_steps:
            k = min(chunk, num_steps - done)
            losses, gnorms = [], []
            for i in range(k):
                gen = torch.Generator(device=self._device).manual_seed(
                    step_seed(base_seed, step0 + done + i))
                self.state, metrics = self._step_fn(self.state,
                                                    sample_batch(gen))
                metrics = self._global_metrics(metrics)
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
            # one host read per chunk
            trace = torch.stack([torch.stack(losses).float(),
                                 torch.stack(gnorms).float()]).cpu().numpy()
            losses, gnorms = trace[0], trace[1]
            done += k
            step = step0 + done
            m = {"loss": float(losses[-1]), "grad_norm": float(gnorms[-1]),
                 "loss_mean": float(np.mean(losses)),
                 "steps_per_sec": done / (time.monotonic() - t0),
                 "loss_trace": losses, "grad_norm_trace": gnorms}
            if metrics_hook is not None:
                metrics_hook(step, m)
            for cb in self.callbacks:
                cb(step, state=self.state, metrics=m)
        return self.state


def step_seed(base_seed: int, step: int) -> int:
    """The seed of global step `step`'s batch generator: base_seed in the
    high 32 bits, the step in the low 32."""
    if not (0 <= base_seed < 2**31 and 0 <= step < 2**32):
        raise ValueError(f"base_seed {base_seed} or step {step} out of range")
    return (base_seed << 32) | step
