"""One body captured as a CUDA graph, and its replay: the layer under the
sampler chains (`sampling/graph.py:Chain`) and the training step
(`train/graph.py:StepGraphs`). Each of those keeps what is its own: when
and how a body warms up, which pool it captures in, what a replay must
do after it. The launch accounting is `kernels/__init__.py`'s.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable

import torch

from tpu_diffusion_torch.kernels import REPLAYED, add, launch_counts
from tpu_diffusion_torch.utils import spans

WARMUP = 2  # warm-up calls of each body before its capture


def capture(body: Callable, stream: torch.cuda.Stream, pool, markers: list,
            generators: Iterable[torch.Generator] = ()):
    """Capture `body` once on `stream` in the memory pool `pool`: (graph,
    the body's output, {kernel: launches of one replay}, capture seconds,
    pool bytes).

    `generators` are those the body draws from (every capture registers
    the card's default one); the body's markers (`spans.mark`) go into
    `markers`. What `torch.cuda.graph` does on entry (synchronise,
    collect, empty the allocator's cache) is done first, so that the
    seconds are the capture's own and the reserved bytes grow by its pool
    segments. A capture that fails raises and leaves the current stream
    and the generators as they were before it."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    device = stream.device
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    main = torch.cuda.current_stream(device)
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        with spans.capturing(markers), torch.cuda.graph(graph, pool=pool,
                                                        stream=stream):
            out = body()
    except RuntimeError:
        # a capture that cannot end raises before `torch.cuda.graph` exits
        # its stream
        torch.cuda.set_stream(main)
        _end_capture(stream, generators)
        raise
    capture_s = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_reserved(device) - reserved
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return graph, out, launches, capture_s, pool_bytes


def _end_capture(stream: torch.cuda.Stream,
                 generators: Iterable[torch.Generator]) -> None:
    """After a capture that could not end: its generators stay in capture
    mode (the graph ends their capture only on success), and refuse eager
    draws ("Offset increment outside graph capture") and other graphs'
    replays. One capture of a single fill ends it; it draws nothing, so
    every generator's seed and offset stay as they were."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=stream):
        torch.zeros(1, device=stream.device)


def replay(graph: torch.cuda.CUDAGraph, launches: Dict[str, int],
           recorder: spans.Recorder, label: str, markers: list) -> None:
    """One replay of a captured graph: its launches added to
    `kernels.REPLAYED`; while `recorder` records, bracketed by timing
    events and its markers read (`Recorder.replay`)."""
    add(REPLAYED, launches)
    if recorder.events is not None:
        recorder.replay(graph, label, markers)
    else:
        graph.replay()
