"""A stretch of the run under `torch.profiler`, reduced to what the
per-layer readers and the result's `breakdown` need: each device
operation's name and interval, the host operations' intervals, and the
stretch's wall time. Kernels launched from a CUDA graph's replay are
recorded one by one by CUPTI, as eager ones are."""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

Interval = Tuple[str, float, float]  # name, start s, end s


@dataclass
class Trace:
    wall_s: float
    units: int
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda iv: iv[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches `pattern`
        (a regular expression searched in the name)."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + e - s
        return [[n[:120], v] for n, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest gaps between device operations, each named by
        the innermost host operation running at its middle."""
        ivs = sorted(self.device, key=lambda iv: iv[1])
        gaps, end = [], None
        for _, s, e in ivs:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) / 2
            over = [iv for iv in self.host if iv[1] <= mid <= iv[2]]
            name = (max(over, key=lambda iv: iv[1])[0][:120] if over
                    else "no host operation")
            out.append([name, e - s])
        return out


def record(fn: Callable[[], int], units: int) -> Trace:
    """Run `fn` (one unit of the cell's work) `units` times under the
    profiler; the caller's units end in a device synchronisation."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        wall = time.perf_counter() - t0
    trace = Trace(wall_s=wall, units=units)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        iv = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        (trace.device if e.device_type == cuda else trace.host).append(iv)
    return trace

