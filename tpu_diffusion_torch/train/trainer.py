"""The training loop, in PyTorch.

Counterpart of `tpu_diffusion/train/trainer.py`: `make_optimizer` (Adam with
the JAX package's three learning-rate schedules and global-norm clipping),
`make_train_step` (loss, gradients, update, EMA, as a host fill and a
device body), the train state, and `Trainer.fit`, whose host loop feeds
batches and fires periodic callbacks; on the card each step replays the
body captured as a CUDA graph (`train/graph.py`), the counterpart of the
JAX package's jitted step.
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
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_diffusion_torch.core.ema import EMAState, ema_blend, ema_fill
from tpu_diffusion_torch.kernels.adam import (Tables, adam_foreach_,
                                              adam_route, fused_adam_ema)
from tpu_diffusion_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                               make_mesh, replicate,
                                               shard_batch)
from tpu_diffusion_torch.parallel.tp import SHARD_ATTR, shard_state_
from tpu_diffusion_torch.train.actions import PeriodicAction
from tpu_diffusion_torch.train.graph import StepGraphs
from tpu_diffusion_torch.utils import spans
from tpu_diffusion_torch.utils.graphs import WARMUP

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
    norm + 1e-6 instead).

    An update is split in two, so that a captured training step
    (`train/graph.py`) replays it: `fill` writes the update's scalars (the
    learning rate from the schedule and the two bias corrections, from the
    host count) into 0-d fp32 device buffers and advances the count, and
    `update` is the device part, optax's `scale_by_adam`, which reads those
    buffers (`torch.optim.Adam` is not this arithmetic, and its capturable
    mode takes no CPU tensors). The moments (`state[p]["exp_avg"]`,
    `["exp_avg_sq"]`) are made at the first update.

    `blend(ema, params)` has every later update blend the EMA too, with
    `core/ema.py:ema_blend`'s arithmetic. `route` says how an update runs:
    "fused" (`kernels/adam.py:fused_adam_ema`: clipping, Adam and the
    blend in one kernel launch, the gradients left unclipped) for
    parameters that are all contiguous fp32 on one CUDA device; else
    "foreach" (the `torch._foreach_*` body, which clips the gradients in
    place, then `ema_blend`), as on the CPU."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = 1.0,
                 mesh: Optional[Mesh] = None):
        self.params = [p for p in params]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.mesh = mesh
        self.state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        device = self.params[0].device
        self.scalars = {k: torch.ones((), dtype=torch.float32, device=device)
                        for k in ("lr", "bc1", "bc2")}
        self.count = 0  # updates made so far
        # (EMA state, parameters by name, {id(parameter): EMA tensor}) of
        # the last `blend`
        self._ema: Optional[Tuple[EMAState, Dict[str, torch.Tensor],
                                  Dict[int, torch.Tensor]]] = None
        self._tables = Tables()  # the kernel's, on the "fused" route

    @property
    def route(self) -> str:
        """"fused" or "foreach" (the class's docstring)."""
        devices = {p.device for p in self.params}
        dtypes = {p.dtype for p in self.params}
        if (len(devices) != 1 or len(dtypes) != 1
                or not all(p.is_contiguous() for p in self.params)):
            return "foreach"
        return adam_route(devices.pop(), dtypes.pop())

    def blend(self, ema: EMAState, params: Mapping[str, torch.Tensor]
              ) -> None:
        """Have every later `update` blend `ema` toward `params` (by name)
        after its Adam step, with the weights of the last `ema_fill`. The
        EMA tensors are paired with this optimizer's parameters by
        identity, once per EMA state."""
        if self._ema is not None and self._ema[0] is ema:
            return
        mine = {id(p) for p in self.params}
        named = dict(params)
        self._ema = (ema, named, {id(named[k]): e
                                  for k, e in ema.params.items()
                                  if id(named[k]) in mine})

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def fill(self) -> None:
        """Write the next update's scalars and advance the count."""
        self.count += 1
        self.scalars["lr"].fill_(self.schedule(self.count - 1))
        self.scalars["bc1"].fill_(1.0 - self.B1 ** self.count)
        self.scalars["bc2"].fill_(1.0 - self.B2 ** self.count)

    @torch.no_grad()
    def update(self, metrics: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """The update from the parameters' `.grad` with the scalars of the
        last `fill`, and the EMA's blend where `blend` bound one; returns
        the gradients' global norm before clipping. With a mesh of ranks,
        the gradients are first averaged in place over its "data" axis,
        and the step's fp32 `metrics` (its loss) with them: one all-reduce,
        so that a captured step replays one collective. On the "fused"
        route the gradients keep their unclipped values; nothing on the
        card reads them after an update."""
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.mesh is not None and self.mesh.device_mesh is not None:
            average_over(grads + list(metrics), self.mesh.group(DATA_AXIS),
                         self.mesh.shape[DATA_AXIS])
        gnorm = global_norm(params)
        clip = (None if self.grad_clip is None else
                self.grad_clip / torch.clamp(gnorm, min=self.grad_clip))
        for p in params:
            if p not in self.state:
                self.state[p] = {"exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        if self.route == "fused":
            self._fused(params, grads, mu, nu, clip)
        else:
            self._foreach(params, grads, mu, nu, clip)
        return gnorm

    def _fused(self, params, grads, mu, nu, clip) -> None:
        """Clipping, Adam and the blend of the parameters' EMA entries in
        one launch; the EMA entries of parameters with no gradient through
        `ema_blend`."""
        emas = decay = rest = None
        if self._ema is not None:
            ema, named, paired = self._ema
            emas = [paired.get(id(p)) for p in params]
            done = {id(p) for p in params}
            ema_blend(ema, named, names=[k for k in ema.params
                                         if id(named[k]) not in done])
            decay, rest = ema.decay, ema.rest
        fused_adam_ema(params, grads, mu, nu, emas, self.scalars["lr"],
                       self.scalars["bc1"], self.scalars["bc2"], clip, decay,
                       rest, self.B1, self.B2, self.EPS, tables=self._tables)

    def _foreach(self, params, grads, mu, nu, clip) -> None:
        """The gradients clipped in place, optax's arithmetic over
        `torch._foreach_*` ops (`kernels/adam.py:adam_foreach_`), then
        `ema_blend`."""
        if clip is not None:
            torch._foreach_mul_(grads, clip)
        adam_foreach_(params, grads, mu, nu, self.scalars["lr"],
                      self.scalars["bc1"], self.scalars["bc2"], self.B1,
                      self.B2, self.EPS)
        if self._ema is not None:
            ema_blend(self._ema[0], self._ema[1])


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


class TrainStep:
    """train_step(state, batch) -> (state, {"loss", "grad_norm"}), the
    metrics as tensors on the device; `grad_norm` is taken before
    clipping.

    A step is `fill(state)`, the host part (the step, optimizer and EMA
    counters, and the per-step scalars written into the optimizer's and
    the EMA's device buffers), then `body(state, batch)`, the device part
    with no host value that changes from step to step: the loss, its
    backward, clipping, the Adam update and the EMA blend, returning
    [loss, grad_norm] as one fp32 tensor. With a mesh of ranks, the loss
    is the global batch's: averaged over "data" in the gradients'
    all-reduce. The eager step sets the gradients
    to None between the two; a captured body (`train/graph.py`) writes them
    in place, and holds two markers (`utils/spans.py:mark`): "forward"
    after the loss and "backward" after its backward. `eager_reason` is
    the loss function's, where it declares one (a loss that reads the host
    inside the step cannot be captured)."""

    def __init__(self, loss_fn: LossFn, ema_decay: float = 0.9999,
                 ema_update_every: int = 1, ema_update_after: int = 0,
                 ema_warmup: bool = True):
        self.loss_fn = loss_fn
        self.ema = dict(decay=ema_decay, update_every=ema_update_every,
                        update_after=ema_update_after, warmup=ema_warmup)
        self.eager_reason: Optional[str] = getattr(loss_fn, "eager_reason",
                                                   None)

    def fill(self, state: TrainState) -> None:
        state.optimizer.fill()
        ema_fill(state.ema, **self.ema)
        state.step += 1

    def body(self, state: TrainState, batch) -> torch.Tensor:
        state.model.train()
        loss = self.loss_fn(state.model, state.generator, batch)
        spans.mark("forward")
        loss.backward()
        spans.mark("backward")
        loss = loss.detach().float().reshape(1)
        state.optimizer.blend(state.ema, state.params)
        gnorm = state.optimizer.update([loss])
        return torch.cat([loss, gnorm.float().reshape(1)])

    def __call__(self, state: TrainState, batch):
        self.fill(state)
        state.optimizer.zero_grad()
        out = self.body(state, batch)
        return state, {"loss": out[0], "grad_norm": out[1]}


def make_train_step(loss_fn: LossFn, ema_decay: float = 0.9999,
                    ema_update_every: int = 1, ema_update_after: int = 0,
                    ema_warmup: bool = True) -> TrainStep:
    """The train step of `loss_fn` (`TrainStep`)."""
    return TrainStep(loss_fn, ema_decay, ema_update_every, ema_update_after,
                     ema_warmup)


class Trainer:
    """fit() = feed batches to the step + fire periodic callbacks.

    Callbacks receive (step, state=..., metrics=...), as `PeriodicCallback`
    expects. `batches` yields global batches: numpy arrays or tensors,
    tuples of them (the (x0, x1) pairs of `losses.cfm.host_ot_pairs`) or
    dicts of them (the {"x", "y"} batches of
    `cli/train_conditional_mnist.py`); each rank keeps its "data" slice and
    moves it to the model's device.

    Route: with `graphed` (the default) and a step of `make_train_step`,
    every step's body goes through `train/graph.py:StepGraphs`: on the card
    a captured CUDA graph replayed per step after the run's first
    `WARMUP` steps, the counterpart of the JAX package's jitted step; on
    the CPU the same body as a plain call. On either route the batch is
    first copied into static buffers. A mesh with a process group and one
    rank on "model" captures its "data" all-reduce (gradients and loss in
    one flat buffer) inside the graph; models that recompute under
    `torch.utils.checkpoint` (`use_checkpoint`, `remat`) are graphed too.
    `eager_reason` says why a Trainer takes the eager loop instead
    (`graphed` is then False): asked to, a step that is not a `TrainStep`,
    a "model" axis of more than one rank (the tensor-parallel gathers,
    `global_norm`'s all-reduce over sharded slices and the ring's sends
    stay outside a capture until a multi-card cell), or a loss that
    declares a host read inside the step (`losses/cfm.py:host_read`).

    `mesh` (default: the optimizer's, else `make_mesh()`, every rank on
    "data"): with a process group, the state is broadcast from the first
    rank, the optimizer (built with the same mesh) averages the gradients
    over "data", and the loss with them; each "data" rank
    draws its own noise for its slice (its generator re-seeded by its
    index; index 0 keeps the seed), where the JAX step draws the global
    batch's with one key (ROADMAP §C). `tensor_parallel` with a
    "model" axis > 1 shards the state (`parallel/tp.py:shard_state_`).

    Spans (`utils/spans.py`, on `recorder`: the step graphs' one, started
    by assigning a list to `graphs.events`): "step" per step, its request
    id the step number, with "step.batch" (the batch into the static
    buffers), "step.fill" (the host part), the body's span of
    `train/graph.py` ("step.eager" on the eager route) and "step.metrics"
    (the host read of the metrics, where a consumer fires).
    """

    def __init__(self, train_step: Callable, state: TrainState,
                 batches: Iterator, mesh: Optional[Mesh] = None,
                 callbacks: Optional[List[Callable]] = None,
                 tensor_parallel: bool = False, graphed: bool = True):
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
        # fit_scanned's batch generator, seeded before every step
        self._batch_gen = torch.Generator(device=self._device)
        self.eager_reason = self._eager_reason(graphed)
        self.graphed = self.eager_reason is None
        self.graphs = StepGraphs(
            state.optimizer.zero_grad, [state.generator, self._batch_gen],
            list(state.model.parameters())
            + list(state.ema.params.values())) if self.graphed else None
        self.recorder = (self.graphs.recorder if self.graphs is not None
                         else spans.Recorder())
        self._inputs: Dict[object, object] = {}

    def _eager_reason(self, graphed: bool) -> Optional[str]:
        if not graphed:
            return "asked for the eager loop (graphed=False)"
        if not isinstance(self._step_fn, TrainStep):
            return "the step is not a make_train_step step"
        if self.mesh.shape[MODEL_AXIS] > 1:
            return (f"a 'model' axis of {self.mesh.shape[MODEL_AXIS]} "
                    "ranks: the tensor-parallel gathers, the sharded "
                    "gradients' norm all-reduce and the ring's sends are "
                    "not captured until a multi-card cell")
        return self._step_fn.eager_reason

    def route(self) -> str:
        """One line for the CLIs: the route the steps take, and why."""
        if not self.graphed:
            return f"eager steps ({self.eager_reason})"
        collective = ("" if self.mesh.device_mesh is None else
                      f", the all-reduce over {self.mesh.shape[DATA_AXIS]}"
                      f" 'data' rank(s) inside")
        if self._device.type == "cuda":
            return (f"graphed steps (one CUDA graph replayed per step after "
                    f"{WARMUP} eager warm-up steps{collective})")
        return f"graphed steps' body as a plain call (CPU{collective})"

    def _static_inputs(self, batch):
        """The static buffers of the batch's structure, shapes and types,
        with the batch copied in, and their key."""
        if isinstance(batch, dict):
            names, parts = list(batch), list(batch.values())
        else:
            names = None
            parts = list(batch) if isinstance(batch, tuple) else [batch]
        parts = [torch.as_tensor(b) for b in parts]
        key = (type(batch).__name__, tuple(names or ()),
               tuple((tuple(b.shape), b.dtype) for b in parts))
        bufs = self._inputs.get(key)
        if bufs is None:
            bufs = [b.to(self._device, copy=True) for b in parts]
            self._inputs[key] = bufs
        else:
            for buf, b in zip(bufs, parts):
                buf.copy_(b)
        if names is not None:
            return key, dict(zip(names, bufs))
        return key, (tuple(bufs) if isinstance(batch, tuple) else bufs[0])

    def _graphed_step(self, key, inputs_of: Callable) -> torch.Tensor:
        """fill, then the body through the step graphs: [loss, grad_norm],
        the graph's static output (copy it before the next step)."""
        with self.recorder.span("step.fill"):
            self._step_fn.fill(self.state)
        return self.graphs.run(key, lambda: self._step_fn.body(
            self.state, inputs_of()))

    def fit(self, num_steps: int,
            metrics_hook: Optional[Callable[[int, Dict], None]] = None
            ) -> TrainState:
        t0 = time.monotonic()
        step0 = self.state.step
        rec = self.recorder
        for local_step in range(num_steps):
            step = step0 + local_step + 1
            with rec.span("step", request=step):
                self._fit_step(step, local_step, t0, metrics_hook)
        return self.state

    def _fit_step(self, step: int, local_step: int, t0: float,
                  metrics_hook) -> None:
        rec = self.recorder
        with rec.span("step.batch"):
            key, inputs = self._static_inputs(
                shard_batch(self.mesh, next(self._batches)))
        if self.graphed:
            out = self._graphed_step(("fit", key), lambda: inputs)
            out = out.clone()
            metrics = {"loss": out[0], "grad_norm": out[1]}
        else:
            with rec.span("step.eager"):
                self.state, metrics = self._step_fn(self.state, inputs)
        # The metrics come to the host (a device synchronisation) only on
        # steps where some consumer runs. Each callback's decision is
        # sampled once and passed back in: an every_secs deadline crossing
        # between this preview and the callback's own re-check would
        # otherwise fire with the device tensors.
        decisions = [getattr(cb, "should_fire", lambda s: True)(step)
                     for cb in self.callbacks]
        if metrics_hook is not None or any(decisions):
            with rec.span("step.metrics"):
                m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = (local_step + 1) / (time.monotonic() - t0)
        else:
            m = metrics  # device tensors; no callback will read them
        if metrics_hook is not None:
            metrics_hook(step, m)
        for cb, d in zip(self.callbacks, decisions):
            if hasattr(cb, "should_fire"):
                cb(step, state=self.state, metrics=m, _fire=d)
            else:
                cb(step, state=self.state, metrics=m)

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
        mesh draw the global batch and keep the slice). On the graphed
        route the sampler runs inside the step's body (the graph replays
        its draws). Inside a chunk nothing is read on the host: each step's
        loss and gradient norm go into a device trace, read once at its
        end (which also bounds how far the host runs ahead). Callbacks and
        the hook fire once per chunk with `loss`, `grad_norm` (the last
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
        gen = self._batch_gen
        rec = self.recorder
        while done < num_steps:
            k = min(chunk, num_steps - done)
            trace = torch.empty((k, 2), dtype=torch.float32,
                                device=self._device)
            for i in range(k):
                with rec.span("step", request=step0 + done + i + 1):
                    with rec.span("step.batch"):
                        gen.manual_seed(step_seed(base_seed,
                                                  step0 + done + i))
                    if self.graphed:
                        out = self._graphed_step(("scanned", sample_batch),
                                                 lambda: sample_batch(gen))
                    else:
                        with rec.span("step.eager"):
                            self.state, metrics = self._step_fn(
                                self.state, sample_batch(gen))
                        out = torch.stack([metrics["loss"].float(),
                                           metrics["grad_norm"].float()])
                    trace[i].copy_(out)
                    if i == k - 1:  # one host read per chunk
                        with rec.span("step.metrics"):
                            trace = trace.T.cpu().numpy()
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


_MASK64 = (1 << 64) - 1


def step_seed(base_seed: int, step: int) -> int:
    """The seed of global step `step`'s batch generator: splitmix64 of
    base_seed in the high 32 bits and the step in the low 32, so every bit
    of the seed depends on both (the CPU generator reads only the low 32
    bits of a seed, the card's philox all 64)."""
    if not (0 <= base_seed < 2**31 and 0 <= step < 2**32):
        raise ValueError(f"base_seed {base_seed} or step {step} out of range")
    z = (((base_seed << 32) | step) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)
