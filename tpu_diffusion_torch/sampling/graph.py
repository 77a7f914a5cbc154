"""Sampler chains as captured CUDA graphs: the port's `jax.jit` over a
`lax.scan` (or a `lax.while_loop`).

The JAX package compiles each fixed-length sampler as one program whose
body is a `lax.scan` step, fed its per-step scalars as stacked inputs
(`tpu_diffusion/sampling/ancestral.py:388-411`). Here a chain is a set of
*bodies* over shared static buffers:

  * a body is one step, or one group of steps (the encoder-reuse samplers
    scan over K-step groups), written with no host value that changes from
    step to step: it reads its per-step inputs (coefficient rows, step
    indices, times) from device tables at a device step counter, the
    buffer "t", which it advances, and writes the chain's carry back into
    its buffers in place;
  * per-call inputs (xT, the condition) and per-replay inputs (noise) are
    static buffers, filled with `copy_` before the chain or the replay;
  * the chain is a sequence of replays of its bodies.

On a CUDA tensor every body is captured once, after a warm-up on a side
stream (so kernel builds, `cudaFuncSetAttribute`, cuBLAS and cuDNN handles
and the models' lazy casts happen outside the capture), as a
`torch.cuda.CUDAGraph` in the memory pool of its `GraphCache`; a capture or
replay that fails raises. On a CPU tensor the same bodies run in a Python
loop: the plain version, which the tests hold against the eager samplers.

A body may differentiate: the guided step of the reconstruction-guidance
chain takes `torch.autograd.grad` of the likelihood loss with respect to a
detached leaf of the iterate buffer, under its own `torch.enable_grad()`,
in its warm-ups and in its capture alike. The backward runs on the
forward's stream, the capture's side stream, and autograd's saved tensors
live in the cache's pool; the sampling models' parameters need no gradient,
so no weight-gradient product is captured.

Noise is drawn outside the graph, before each replay, by the same calls in
the same order as the eager chain, and copied into the static buffers: the
graphed chain draws what the eager one draws from the same generator (or
noise source), and holds one replay's noise, not the chain's.

The kernel wrappers count their launches when they are called, which for a
graphed chain is at its warm-up and capture; `Chain.launches` keeps each
body's count at capture and `Chain.replays` its replays, so
`GraphCache.replayed_launches` is what one cache's replays launched, and
`executed_launches()` what ran on the card in all: the wrappers' counts
less the warm-ups' and captures' (`OVERHEAD`), plus every replay's
(`REPLAYED`).

Tracing (`utils/spans.py`): each cache has a recorder, started by
assigning a list to `GraphCache.events` and stopped by assigning `None`.
While it records, `scan` opens a span "chain" per call, with children
"chain.lookup" (`GraphCache.chain`: the parameters' state, any rebuild),
"chain.capture" (warm-ups and captures), "chain.inputs" (the copies into
the static buffers), "chain.fill" and "chain.launch" per replay (its
noise; the replay, tagged with the body's signature) and "chain.output"
(the copy of the result), and every replay is bracketed by timing events.
A body may call `spans.mark(name)`: captured as an event node, read back
after the replay.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from tpu_diffusion_torch.utils import spans

WARMUP = 2  # warm-up calls of each body before its capture
# kernel launches counted by the wrappers during warm-ups and captures, and
# launched by replays, over every chain of the process
OVERHEAD: Dict[str, int] = {}
REPLAYED: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    from tpu_diffusion_torch.kernels import (adam, attention, groupnorm,
                                             resblock)
    return {"flash_attention_fused": attention.launches,
            "flash_attention_fwd": attention.flash_fwd_launches,
            "flash_attention_bwd": attention.flash_bwd_launches,
            "flash_cross_attention": attention.flash_xattn_launches,
            "fused_groupnorm_silu": groupnorm.launches,
            "fused_groupnorm_silu_bwd": groupnorm.backward_launches,
            "fused_resblock": resblock.launches,
            "fused_adam_ema": adam.launches}


def _add(total: Dict[str, int], counts: Dict[str, int], times: int = 1):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n * times


def executed_launches() -> Dict[str, int]:
    """Kernel launches that ran on the card outside warm-ups and captures:
    the wrappers' counts less `OVERHEAD`, plus `REPLAYED`."""
    return {name: n - OVERHEAD.get(name, 0) + REPLAYED.get(name, 0)
            for name, n in launch_counts().items()}


def counter(device) -> torch.Tensor:
    """A chain's step counter: a 0-d int64 buffer."""
    return torch.zeros((), dtype=torch.long, device=device)


def row_at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """table[t] for a 0-d device counter t, without a host read (indexing by
    a 0-d tensor reads it on the host)."""
    return table.index_select(0, t.view(1))[0]


def rows_at(table: torch.Tensor, t: torch.Tensor, n: int) -> torch.Tensor:
    """[n] copies of table[t] (a batch's step index)."""
    return table.index_select(0, t.expand(n))


class Chain:
    """The bodies of one chain over its static `buffers`, each captured once
    on the card (`graphs`) or run as it is on the CPU. `launches[sig]` is
    the kernel launches a replay of body `sig` makes, `replays[sig]` its
    replays so far, `capture_s[sig]` and `pool_bytes[sig]` the seconds its
    capture took and the memory the card reserved for it, `markers[sig]`
    the (name, event) pairs its body marked in the capture."""

    def __init__(self, cache: "GraphCache", buffers: Dict[str, torch.Tensor],
                 bodies: Dict[object, Callable[[], None]]):
        self.buffers = buffers
        self.bodies = bodies
        self.graphs: Dict[object, torch.cuda.CUDAGraph] = {}
        self.launches: Dict[object, Dict[str, int]] = {}
        self.replays = {sig: 0 for sig in bodies}
        self.capture_s: Dict[object, float] = {}
        self.pool_bytes: Dict[object, int] = {}
        self.markers: Dict[object, list] = {}
        self._cache = cache
        self.device = next(iter(buffers.values())).device
        if self.device.type == "cuda":
            with cache.recorder.span("chain.capture"):
                self._capture()

    def _zero(self) -> None:
        for b in self.buffers.values():
            b.zero_()

    def _capture(self) -> None:
        cache = self._cache
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
            cache.stream = torch.cuda.Stream(self.device)
        side = cache.stream
        start = launch_counts()
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for body in self.bodies.values():
                for _ in range(WARMUP):
                    self._zero()  # keeps the counter inside the tables
                    body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        for sig, body in self.bodies.items():
            self._zero()
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            # what `torch.cuda.graph` frees on entry, freed here first, so
            # the reserved bytes grow by the capture's own pool segments
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            with spans.capturing(self.markers.setdefault(sig, [])), \
                    torch.cuda.graph(graph, pool=cache.pool, stream=side):
                body()
            self.capture_s[sig] = time.perf_counter() - t0
            self.pool_bytes[sig] = (torch.cuda.memory_reserved(self.device)
                                    - reserved)
            after = launch_counts()
            self.launches[sig] = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
            self.graphs[sig] = graph
        torch.cuda.current_stream(self.device).wait_stream(side)
        end = launch_counts()
        _add(OVERHEAD, {k: end[k] - start[k] for k in end})

    def replay(self, sig) -> None:
        self.replays[sig] += 1
        rec = self._cache.recorder
        with rec.span("chain.launch", tag=sig):
            if not self.graphs:
                self.bodies[sig]()
                return
            _add(REPLAYED, self.launches[sig])
            if rec.events is not None:
                rec.replay(self.graphs[sig], "chain/%d" % (
                    len(sig) if isinstance(sig, tuple) else 1),
                    self.markers[sig])
            else:
                self.graphs[sig].replay()

    def run(self, units, fill: Optional[Callable] = None) -> None:
        """Replay `units` in order: each a (sig, unit) pair, with
        `fill(unit)` filling the replay's inputs first."""
        rec = self._cache.recorder
        for sig, unit in units:
            if fill is not None:
                with rec.span("chain.fill"):
                    fill(unit)
            self.replay(sig)


class GraphCache:
    """The captured chains of one model, in one memory pool.

    `chain(slot, fn, build)` returns the chain of `slot` (the sampler and
    its shapes, types and fixed arguments), built by `build() -> (buffers,
    bodies)` and captured on first use, and built again when the callable
    `fn` or the state of `module`'s parameters (their addresses and version
    counters: an in-place update, a reallocation) differs from the chain's:
    a graph replays the addresses it was captured with, including those of
    the models' cast copies of their weights, which a parameter update
    reallocates. The stale chain is dropped first, so its graphs' memory
    goes back to the pool. `clear()` frees every graph. With `events` set
    to a list, every replay on the card appends its (start, end) CUDA
    events, so the chains' device time is their sum: setting it starts the
    cache's `recorder` (`utils/spans.py`), setting `None` stops it.
    """

    events = spans.Switch()

    def __init__(self, module: Optional[torch.nn.Module] = None):
        self.module = module
        self.chains: Dict[object, Chain] = {}
        self.captures = 0
        self.pool = None
        self.stream = None
        self.recorder = spans.Recorder()

    def _state(self) -> tuple:
        if not isinstance(self.module, torch.nn.Module):
            return ()  # a plain callable: no parameters to follow
        return tuple((p.data_ptr(), p._version)
                     for p in self.module.parameters())

    def chain(self, slot, fn, build) -> Chain:
        state = self._state()
        hit = self.chains.get(slot)
        if hit is not None and hit.fn is fn and hit.state == state:
            return hit
        self.chains.pop(slot, None)
        buffers, bodies = build()
        chain = Chain(self, buffers, bodies)
        chain.fn, chain.state = fn, state
        self.chains[slot] = chain
        self.captures += 1
        return chain

    def clear(self) -> None:
        self.chains.clear()

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by the replays of every chain held."""
        total: Dict[str, int] = {}
        for chain in self.chains.values():
            for sig, counts in chain.launches.items():
                _add(total, counts, chain.replays[sig])
        return total

    def device_ms(self) -> float:
        """The summed device time of the replays timed since `events` was
        last set (synchronises)."""
        if not self.events:
            return 0.0
        self.events[-1][1].synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def scan(cache: GraphCache, slot, fn, x: torch.Tensor, groups, make_step,
         *, inputs: Optional[Dict[str, torch.Tensor]] = None,
         sig_of: Callable = lambda step: None,
         draws_of: Callable = lambda sig: (),
         draw: Optional[Callable] = None, outputs: tuple = ()):
    """The chain from carry `x` over `groups` (lists of steps in the chain's
    order; one group is one replay), through `cache`. Returns the final
    carry, a new tensor, or with `outputs` (buffer names the steps update
    in place) a tuple of it and copies of those buffers.

    `make_step(buf)` is called when the chain is built and returns
    `step(scratch, x, t, j, sig, noise) -> x`, one step of the chain: `buf`
    holds the static buffers ("x", the counter "t", and one per entry of
    `inputs`, copied in before every chain), `t` is the counter (the
    step's position in the chain, which `scan` advances after each step), `j`
    the step's place in its group, `scratch` a dict the steps of one group
    share (an encoder cache), `sig = sig_of(step)` the step's signature
    (steps of other signatures, and groups of other signature sequences, get
    bodies of their own) and `noise` its noise tensors. `draws_of(sig)` lists
    the noise a step of signature `sig` draws, in the eager chain's order,
    as (kind, j, like) with `like` a buffer name; before each replay
    `draw(buf[like], kind, step, j)` draws it and the result is copied into
    the static buffer `noise_<like>`.
    """
    inputs = inputs or {}
    full_slot = (slot, tuple(x.shape), x.dtype, str(x.device),
                 tuple((k, tuple(v.shape), v.dtype)
                       for k, v in inputs.items()))
    gsigs = [tuple(sig_of(s) for s in group) for group in groups]

    def counts(gsig) -> Dict[str, int]:
        n: Dict[str, int] = {}
        for sig in gsig:
            for _, _, like in draws_of(sig):
                n[like] = n.get(like, 0) + 1
        return n

    def build():
        buf = {"x": torch.zeros_like(x), "t": counter(x.device)}
        buf.update({k: torch.zeros_like(v) for k, v in inputs.items()})
        most: Dict[str, int] = {}
        for gsig in dict.fromkeys(gsigs):
            for like, n in counts(gsig).items():
                most[like] = max(most.get(like, 0), n)
        for like, n in most.items():
            src = buf[like]
            buf["noise_" + like] = torch.zeros((n,) + tuple(src.shape),
                                               dtype=src.dtype,
                                               device=src.device)
        step = make_step(buf)

        def body_of(gsig):
            def body():
                xi, t, scratch = buf["x"], buf["t"], {}
                used: Dict[str, int] = {}
                for j, sig in enumerate(gsig):
                    noise = []
                    for _, _, like in draws_of(sig):
                        k = used.get(like, 0)
                        noise.append(buf["noise_" + like][k])
                        used[like] = k + 1
                    xi = step(scratch, xi, t, j, sig, noise)
                    t.add_(1)
                buf["x"].copy_(xi)
            return body

        # in first-use order: captured in the order they first replay
        return buf, {gsig: body_of(gsig) for gsig in dict.fromkeys(gsigs)}

    rec = cache.recorder
    with rec.span("chain"):
        with rec.span("chain.lookup"):
            chain = cache.chain(full_slot, fn, build)
        buf = chain.buffers
        with rec.span("chain.inputs"):
            buf["x"].copy_(x)
            buf["t"].zero_()
            for k, v in inputs.items():
                buf[k].copy_(v)

        def fill(group) -> None:
            used: Dict[str, int] = {}
            for step in group:
                for kind, j, like in draws_of(sig_of(step)):
                    k = used.get(like, 0)
                    buf["noise_" + like][k].copy_(
                        draw(buf[like], kind, step, j))
                    used[like] = k + 1

        chain.run(zip(gsigs, groups), fill)
        with rec.span("chain.output"):
            if outputs:
                return (buf["x"].clone(),) + tuple(buf[k].clone()
                                                   for k in outputs)
            return buf["x"].clone()
