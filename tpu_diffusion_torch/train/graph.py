"""The training step as a captured CUDA graph: the port's
`jax.jit(train_step)` (`tpu_diffusion/train/trainer.py:131`) and, inside
`Trainer.fit_scanned`, the body of its `lax.scan` (`:222-223`).

A step is `TrainStep.fill` on the host (counters and the per-step scalars,
written into device buffers) and then `TrainStep.body` on the device: the
loss, its backward, clipping, Adam and the EMA blend, over static inputs
(the batch buffers of `Trainer.fit`, or the draws of `fit_scanned`'s
sampler from its generator). `StepGraphs.run(key, body)` runs one step's
body:

  * on a CPU tensor, as a plain Python call after setting the gradients to
    None: the plain version, which the tests hold against the JAX step;
  * on the card, the first `WARMUP` steps of each key (the batch's
    structure, shapes and types: JAX traces again per shape) run eagerly,
    on a side stream, as the run's own steps (a throwaway call would be an
    optimizer step). They build the kernels, the cuBLAS and cuDNN handles
    and Adam's moments outside the capture. Then the body is captured once
    in a memory pool of its own, with the gradients set to None first, so
    that the backward allocates them in the pool and every replay writes
    them in place; every later step of the key replays the graph. A
    capture or replay that fails raises.

Draws: the graph registers the generators the body draws from (the train
state's and `fit_scanned`'s batch generator; the card's default generator
is registered by every capture), so each replay reads the generator's
current seed and offset and advances it as the eager step does: a graphed
step draws what an eager step draws. `fit_scanned` seeds its batch
generator before every step. A rematerialised model (`use_checkpoint`,
`remat`) draws its dropout masks before each checkpointed block and hands
them to the recomputation, which draws nothing.

Collectives: under a process group whose "model" axis is one rank, the
body's all-reduce over "data" (the gradients and the loss in one flat
buffer, `train/trainer.py:average_over`) is captured with the rest: NCCL
launches it on the capture stream and every replay runs it again. The
warm-ups run the first all-reduces outside the capture, which creates the
communicator there.

The body's output ([loss, grad_norm]) is a static tensor: the caller copies
it before the next replay. A replay updates the parameters without bumping
their version counters, which the models' cast copies
(`models/nn.py:_CastParams`) and the sampler chains (`sampling/graph.py:
GraphCache`) read to see a change: every replay bumps them.

Capture, replay and launch accounting are `utils/graphs.py`'s and
`kernels/__init__.py`'s: the kernel wrappers count at the warm-ups (which
ran) and at the capture (which did not: `kernels.OVERHEAD`), and each
replay adds the capture's counts to `kernels.REPLAYED`, so
`kernels.executed_launches()` is what ran on the card.

Tracing (`utils/spans.py`): the recorder of `StepGraphs.recorder` is
started by assigning a list to `StepGraphs.events` and stopped by
assigning `None`. `run` opens "step.eager" (a warm-up), "step.capture" or
"step.launch" (a replay, or the plain call on the CPU) inside the
Trainer's "step" span, and the body's markers ("forward", "backward",
`train/trainer.py:TrainStep.body`) are captured as event nodes and read
back after each replay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from tpu_diffusion_torch.kernels import OVERHEAD, add
from tpu_diffusion_torch.utils import graphs, spans


class _Entry:
    """One key's warm-ups, graph, static output and accounting."""

    def __init__(self):
        self.warm = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.markers: list = []
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0


class StepGraphs:
    """The captured training steps of one Trainer, by key.

    `generators` are the generators the bodies draw from; `versioned` the
    tensors the body updates in place (parameters and EMA), whose version
    counters each replay bumps. With `events` set to a list, every replay
    appends its (start, end) CUDA events: setting it starts `recorder`,
    setting `None` stops it."""

    events = spans.Switch()

    def __init__(self, zero_grad: Callable[[], None],
                 generators: List[Optional[torch.Generator]],
                 versioned: List[torch.Tensor]):
        self.zero_grad = zero_grad
        self.generators = [g for g in generators
                           if g is not None and g.device.type == "cuda"]
        self.versioned = versioned
        self.device = versioned[0].device
        self.entries: Dict[object, _Entry] = {}
        self.stream: Optional[torch.cuda.Stream] = None
        self.recorder = spans.Recorder()

    def run(self, key, body: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One step's body: eager (a warm-up), captured then replayed, or
        replayed; on the CPU a plain call. Returns its [loss, grad_norm]."""
        rec = self.recorder
        if self.device.type != "cuda":
            with rec.span("step.launch"):
                self.zero_grad()
                return body()
        e = self.entries.setdefault(key, _Entry())
        if e.graph is None:
            if e.warm < graphs.WARMUP:
                e.warm += 1
                with rec.span("step.eager"):
                    return self._eager(body)
            with rec.span("step.capture"):
                self._capture(e, body)
        with rec.span("step.launch"):
            return self._replay(e)

    def _side(self) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        return self.stream

    def _eager(self, body) -> torch.Tensor:
        side, main = self._side(), torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.zero_grad()
            out = body()
        main.wait_stream(side)
        out.record_stream(main)
        return out

    def _capture(self, e: _Entry, body) -> None:
        self.zero_grad()  # the backward allocates them in the pool
        e.graph, e.out, e.launches, e.capture_s, e.pool_bytes = (
            graphs.capture(body, self._side(), torch.cuda.graph_pool_handle(),
                           e.markers, self.generators))
        add(OVERHEAD, e.launches)

    def _replay(self, e: _Entry) -> torch.Tensor:
        e.replays += 1
        graphs.replay(e.graph, e.launches, self.recorder, "step/1",
                      e.markers)
        for t in self.versioned:
            torch.autograd.graph.increment_version(t)
        return e.out

    def captured(self) -> Dict[object, _Entry]:
        """The keys captured so far."""
        return {k: e for k, e in self.entries.items() if e.graph is not None}
