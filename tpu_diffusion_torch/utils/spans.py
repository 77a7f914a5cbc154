"""The port's one tracing mechanism: host spans, device intervals of graph
replays and markers inside the captured bodies, on the host's
`time.perf_counter()` clock.

A `Recorder` belongs to one owner: each `sampling/graph.py:GraphCache`
and `train/graph.py:StepGraphs` has its own, and `PROCESS` serves
`utils/debug.py:trace`. Assigning a list to the owner's `events` (a
`Switch`) starts its recorder (`start(events)`), assigning `None` stops it
(`stop()`); what it recorded stays until the next start. While it
records:

  * a span (`with rec.span(name): ...`) keeps its name, start, end, parent
    span and request id: a top-level span without one takes the next
    sequence number (a chain), children take their parent's;
  * `replay(graph, label, markers)` brackets a graph's replay with two
    timing events, appended to `events` as (start, end), the contract of
    `GraphCache.device_ms()` and the benchmark's `idle_share.*`; before
    each launch of a body it reads that body's previous replay (start
    event, its markers, end event) if the end event has completed, never
    synchronising: a replay not yet complete is counted `unread`;
  * `start` and `stop` each take an anchor: after a synchronisation an
    event is recorded and bracketed by `perf_counter()` before and after
    its completion, which places device events on the host clock.

Off, a span site costs one attribute test and a no-op context: no clock
read, no allocation, no event. While a `torch.profiler` is active a span
also opens `torch.profiler.record_function(name)`; `annotating()` (entered
by `utils/debug.py:profile`) makes every recorder's spans do that, so the
profiler's trace names the program's host phases.

Markers: `mark(name)`, called inside a body, records a timing event as an
external node of the graph being captured (`capturing(markers)` around a
capture), and is a no-op anywhere else: in warm-ups, eager steps and on
the CPU. The node is captured whether the recorder is on or off; each
replay re-records it, so only the last replay's marker can be read.

`summary(t0, t1)` reads every recorder alive in the process (a weak
registry) over the host window [t0, t1]: spans by name, replay and gap
seconds, each gap second attributed to the innermost span open on the host
or to `caller`, the turn between consecutive requests, the marker splits
and the anchors' brackets and drift.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import weakref
from time import perf_counter
from typing import Dict, List, Optional

import torch

RECORD, ANNOTATE = 1, 2
CALLER = "caller"  # the gap's name where no program span is open

_REGISTRY: "weakref.WeakSet[Recorder]" = weakref.WeakSet()
_annotating = 0  # depth of `annotating()` blocks
_capture: Optional[list] = None  # the markers of the body being captured


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


_OFF = contextlib.nullcontext()  # the span of a recorder that is off


class _Span:
    __slots__ = ("rec", "name", "request", "tag", "row", "range")

    def __init__(self, rec, name, request, tag):
        self.rec, self.name, self.request, self.tag = rec, name, request, tag
        self.row = self.range = None

    def __enter__(self):
        rec = self.rec
        if _profiling():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if rec.on & RECORD:
            parent = rec._open[-1] if rec._open else None
            if self.request is not None:
                rec.request = self.request
            elif parent is None:
                rec.chains += 1
                rec.request = rec.chains
            self.row = [self.name, perf_counter(), None, parent, rec.request,
                        self.tag]
            rec._open.append(len(rec.spans))
            rec.spans.append(self.row)
        return None

    def __exit__(self, *exc):
        rec = self.rec
        if self.row is not None:
            self.row[2] = perf_counter()
            # a stop or a start inside the span has emptied the stack
            if rec._open and rec.spans[rec._open[-1]] is self.row:
                rec._open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class Recorder:
    """The spans, replays and marker reads of one owner (see the module's
    docstring). `events` is the switch's list while recording, else None;
    `spans` rows are [name, start s, end s, parent index, request, tag],
    `replays` rows (launch s, label, request, start event, end event),
    `reads` rows (launch s, label, request, segment names, segment ms)."""

    def __init__(self, annotate: bool = False):
        self.on = ANNOTATE if (annotate or _annotating) else 0
        self.always_annotate = annotate
        self.events: Optional[list] = None
        self._clear()
        _REGISTRY.add(self)

    def _clear(self) -> None:
        self.spans: List[list] = []
        self._open: List[int] = []
        self.replays: List[tuple] = []
        self.reads: List[tuple] = []
        self.unread: List[float] = []  # launch times of replays unread
        self.anchors: List[tuple] = []  # (event, before s, after s)
        self._last: Dict[object, tuple] = {}  # graph -> its last replay
        self.request = None
        self.chains = 0

    def span(self, name: str, request=None, tag=None):
        """A context for a span named `name` (`request` sets the request
        id; `tag` is kept with it)."""
        if not self.on:
            return _OFF
        return _Span(self, name, request, tag)

    # -- the switch ------------------------------------------------------

    def start(self, events: list) -> None:
        """Record from now on, appending each replay's (start, end) events
        to `events`; what an earlier start recorded is dropped."""
        self._clear()
        self.events = events
        self.on |= RECORD
        anchor = _anchor()
        if anchor is not None:
            self.anchors.append(anchor)

    def stop(self) -> None:
        """Stop recording; read the last replay of each body, take the
        second anchor. What was recorded stays until the next start."""
        if not self.on & RECORD:
            return
        if self.anchors:
            self.anchors.append(_anchor())
        for last in self._last.values():
            self._read(last)
        self._last.clear()
        self._open.clear()
        self.events = None
        self.on &= ~RECORD

    # -- device intervals ------------------------------------------------

    def replay(self, graph, label: str, markers: list) -> None:
        """`graph.replay()` between two timing events, read back later;
        first the previous replay of `graph` is read if it has completed.
        Call only while recording."""
        last = self._last.get(graph)
        if last is not None:
            self._read(last)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = perf_counter()
        start.record()
        graph.replay()
        end.record()
        self.events.append((start, end))
        self.replays.append((t, label, self.request, start, end))
        self._last[graph] = (t, label, self.request, start, end, markers)

    def _read(self, last: tuple) -> None:
        t, label, request, start, end, markers = last
        if not markers:
            return
        if not end.query():
            self.unread.append(t)
            return
        evs = [start] + [ev for _, ev in markers] + [end]
        self.reads.append((t, label, request,
                           [n for n, _ in markers] + ["end"],
                           [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]))


class Switch:
    """The `events` attribute of a recorder's owner (an object with a
    `recorder`): reads the recorder's list, or None when it is off;
    assigning a list starts the recorder, assigning None stops it."""

    def __get__(self, owner, cls=None):
        return self if owner is None else owner.recorder.events

    def __set__(self, owner, events: Optional[list]) -> None:
        if events is None:
            owner.recorder.stop()
        else:
            owner.recorder.start(events)


def _anchor():
    """(event, perf_counter before, after) with the event recorded on an
    idle device, or None without a card."""
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    before = perf_counter()
    ev.record()
    ev.synchronize()
    return ev, before, perf_counter()


PROCESS = Recorder(annotate=True)


@contextlib.contextmanager
def annotating():
    """Every recorder's spans open `record_function` ranges inside the
    block while a profiler is active, whether or not they record."""
    global _annotating
    _annotating += 1
    for rec in list(_REGISTRY):
        rec.on |= ANNOTATE
    try:
        yield
    finally:
        _annotating -= 1
        if not _annotating:
            for rec in list(_REGISTRY):
                if not rec.always_annotate:
                    rec.on &= ~ANNOTATE


# -- markers inside captured bodies -------------------------------------

@contextlib.contextmanager
def capturing(markers: list):
    """Around a graph's capture: `mark` appends (name, event) to
    `markers`."""
    global _capture
    outer, _capture = _capture, markers
    try:
        yield markers
    finally:
        _capture = outer


def mark(name: str) -> None:
    """A timing event recorded as an external node of the graph being
    captured; a no-op outside a capture."""
    if _capture is None:
        return
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    _capture.append((name, ev))


# -- the summary ----------------------------------------------------------

def _median(values):
    return statistics.median(values) if values else None


def summary(t0: float, t1: float) -> Optional[dict]:
    """What every live recorder holds over the host window [t0, t1]
    (`perf_counter()` seconds), or None where none holds a span or a
    replay. Gap seconds are the window's seconds outside replays; each is
    attributed to the innermost span open on the host at that moment (on
    the device clock from the end of the replay before it, placed on the
    host clock by the recorder's start anchor), or to `caller`."""
    recs = [r for r in list(_REGISTRY) if r.spans or r.replays]
    if not recs:
        return None
    out = {"window_s": t1 - t0, "spans": _span_table(recs, t0, t1)}
    out.update(_device(recs, t0, t1))
    out["markers"], out["unread"] = _markers(recs, t0, t1)
    return out


def _clip(a, b, t0, t1):
    return max(a, t0), min(b, t1)


def _span_table(recs, t0, t1) -> dict:
    table: Dict[str, dict] = {}
    for rec in recs:
        child = [0.0] * len(rec.spans)
        spans = []
        for i, (name, a, b, parent, _, _) in enumerate(rec.spans):
            a, b = _clip(a, t1 if b is None else b, t0, t1)
            if b < a:
                continue
            spans.append((i, name, b - a))
            if parent is not None:
                child[parent] += b - a
        for i, name, d in spans:
            row = table.setdefault(name, {"count": 0, "host_s": 0.0,
                                          "self_s": 0.0})
            row["count"] += 1
            row["host_s"] += d
            row["self_s"] += d - child[i]
    return table


def _innermost(recs):
    """The host timeline as change points (time, name, request): from each
    time on, the innermost span open is `name` (or `caller`)."""
    marks = []
    for r, rec in enumerate(recs):
        for i, (name, a, b, _, req, _) in enumerate(rec.spans):
            b = float("inf") if b is None else b
            if b > a:  # a span of no length covers no time
                marks.append((a, 1, (r, i), name, req))
                marks.append((b, 0, (r, i), name, req))
    marks.sort(key=lambda m: (m[0], m[1]))
    open_, points = [], [(float("-inf"), CALLER, None)]
    for t, opening, key, name, req in marks:
        if opening:
            open_.append((key, name, req))
        else:
            open_ = [o for o in open_ if o[0] != key]
        top = open_[-1][1:] if open_ else (CALLER, None)
        if points[-1][0] == t:
            points[-1] = (t,) + top
        else:
            points.append((t,) + top)
    return points


def _attribute(points, times, a, b, into: dict) -> tuple:
    """Adds [a, b]'s seconds to `into` by innermost span; returns the
    name and request that took the most of it."""
    k = bisect.bisect_right(times, a) - 1
    share: Dict[tuple, float] = {}
    while a < b:
        end = times[k + 1] if k + 1 < len(times) else b
        d = min(end, b) - a
        if d > 0:
            _, name, req = points[k]
            into[name] = into.get(name, 0.0) + d
            share[(name, req)] = share.get((name, req), 0.0) + d
        a, k = max(a, end), k + 1
    return max(share, key=share.get) if share else (CALLER, None)


def _device(recs, t0, t1) -> dict:
    placed = []  # (host start, host end, seconds, recorder, row)
    anchors = []
    for rec in recs:
        if not rec.replays or not rec.anchors:
            continue
        ev0, a0, b0 = rec.anchors[0]
        mid0 = (a0 + b0) / 2
        anchor = {"start_bracket_us": (b0 - a0) * 1e6}
        if len(rec.anchors) > 1:
            ev1, a1, b1 = rec.anchors[-1]
            device = ev0.elapsed_time(ev1) / 1e3
            anchor.update(stop_bracket_us=(b1 - a1) * 1e6,
                          span_s=(a1 + b1) / 2 - mid0,
                          drift_us=((a1 + b1) / 2 - mid0 - device) * 1e6)
        anchors.append(anchor)
        for row in rec.replays:
            s = mid0 + ev0.elapsed_time(row[3]) / 1e3
            d = row[3].elapsed_time(row[4]) / 1e3
            placed.append((s, s + d, d, rec, row))
    if not placed:
        return {}
    placed.sort(key=lambda p: p[0])
    inside = [p for p in placed if p[1] > t0 and p[0] < t1]
    points = _innermost(recs)
    times = [p[0] for p in points]
    by_span: Dict[str, float] = {}
    gaps, busy = [], 0.0

    def gap(a, g):
        name, req = _attribute(points, times, a, a + g, by_span)
        gaps.append((g, name, req))

    edge, prev = t0, None
    for p in inside:
        s, e = _clip(p[0], p[1], t0, t1)
        if prev is not None and prev[3] is p[3]:
            # on the device clock: the end event before to this start
            g = max(prev[4][4].elapsed_time(p[4][3]) / 1e3, 0.0)
        else:
            g = max(s - edge, 0.0)
        if g > 0:
            gap(edge, g)
        busy += max(e - max(s, edge), 0.0)
        edge, prev = max(edge, e), p
    if edge < t1:
        gap(edge, t1 - edge)
    out = {"replays": len(inside), "replay_s": busy,
           "gap_s": sum(g for g, _, _ in gaps),
           "gaps": {"count": len(gaps), "by_span": by_span,
                    "longest": [list(g) for g in
                                sorted(gaps, key=lambda x: -x[0])[:5]]},
           "anchors": anchors}
    out["turns"], out["requests"] = _per_request(inside)
    return out


def _per_request(inside):
    """By kind (a label's part before "/"): the device ms from a request's
    last replay's end to the next request's first replay's start, and
    each request's summed replay ms."""
    runs: Dict[tuple, list] = {}  # (recorder, kind) -> requests in order
    for p in inside:
        _, label, req, start, end = p[4]
        reqs = runs.setdefault((id(p[3]), label.split("/")[0]), [])
        if not reqs or reqs[-1]["id"] != req:
            reqs.append({"id": req, "first": start, "ms": 0.0})
        reqs[-1]["last"] = end
        reqs[-1]["ms"] += p[2] * 1e3
    turns: Dict[str, list] = {}
    totals: Dict[str, list] = {}
    for (_, kind), reqs in runs.items():
        turns.setdefault(kind, []).extend(
            a["last"].elapsed_time(b["first"]) for a, b in zip(reqs,
                                                              reqs[1:]))
        totals.setdefault(kind, []).extend(r["ms"] for r in reqs)
    return ({k: {"count": len(v), "median_ms": _median(v),
                 "max_ms": max(v) if v else None}
             for k, v in turns.items()},
            {k: {"count": len(v), "replay_ms_median": _median(v)}
             for k, v in totals.items()})


def _markers(recs, t0, t1):
    by: Dict[str, dict] = {}
    unread = 0
    for rec in recs:
        unread += sum(1 for t in rec.unread if t0 <= t <= t1)
        for t, label, _, names, segs in rec.reads:
            if not t0 <= t <= t1:
                continue
            row = by.setdefault(label, {"names": names, "segs": []})
            row["segs"].append(segs)
    out = {}
    for label, row in by.items():
        segs = row["segs"]
        out[label] = {"count": len(segs), "names": row["names"],
                      "median_ms": [_median([s[i] for s in segs])
                                    for i in range(len(row["names"]))],
                      "replay_ms_median": _median([sum(s) for s in segs])}
    return out, unread
