"""The port's tracing (`tpu_diffusion_torch/utils/spans.py`) on the CPU:
the recorders of the graphed chains and the training step, off and on, and
the summary's arithmetic on synthetic device intervals."""

import json
import os
import weakref

import pytest
import torch
from torch import nn

from tests.torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.sampling import ancestral
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.train import trainer
from tpu_diffusion_torch.utils import debug, spans

CHAIN = ["chain", "chain.lookup", "chain.inputs", "chain.fill",
         "chain.launch", "chain.fill", "chain.launch", "chain.fill",
         "chain.launch", "chain.output"]


def _sampler(graphs):
    """DDIM over 7 steps at encoder reuse 3 (groups of 1, 3 and 3) on a
    tiny encoder and decoder."""
    w = torch.randn((3, 3), generator=torch.Generator().manual_seed(0))
    return ancestral.make_cached_ddim_sampler(
        lambda x, i: x @ w, lambda x, i, c: torch.tanh(c + x) * 0.1,
        DDPM.create(100), num_steps=7, encoder_reuse=3, graphs=graphs)


def _x():
    return torch.randn((2, 4, 4, 3), generator=torch.Generator()
                       .manual_seed(1))


def _trainer(seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = nn.Sequential(nn.Linear(3, 8), nn.Tanh(), nn.Linear(8, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = trainer.make_optimizer(model.parameters(), 1e-2, grad_clip=1.0)
    state = trainer.TrainState.create(model, opt,
                                      torch.Generator().manual_seed(seed))

    def loss(model, g, x):
        noise = torch.randn(x.shape, generator=g)
        return (model(x + noise) - x).square().mean()

    batches = iter([torch.randn((4, 3), generator=gen).numpy()
                    for _ in range(8)])
    return trainer.Trainer(trainer.make_train_step(loss, ema_decay=0.9),
                           state, batches)


class Counted:
    """Counts the calls of a callable it stands in for."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def test_off_stores_no_span_and_creates_no_event(monkeypatch):
    """Off (the default), a chain's plain version and a `Trainer.fit` step
    read no clock of the recorder's, create no CUDA event and store
    nothing."""
    clock = Counted(spans.perf_counter)
    event = Counted(torch.cuda.Event)
    monkeypatch.setattr(spans, "perf_counter", clock)
    monkeypatch.setattr(torch.cuda, "Event", event)
    graphs = GraphCache()
    _sampler(graphs)(_x())
    tr = _trainer()
    tr.fit(2, metrics_hook=lambda s, m: None)
    assert tr.graphed
    for rec in (graphs.recorder, tr.recorder):
        assert not rec.on and rec.events is None
        assert rec.spans == [] and rec.replays == [] and rec.reads == []
    assert clock.calls == 0 and event.calls == 0


def _tree(rec):
    """(name, parent's name, request) of every span."""
    return [(name, None if parent is None else rec.spans[parent][0], req)
            for name, _, _, parent, req, _ in rec.spans]


def test_chain_spans_nest_one_request_per_chain():
    graphs = GraphCache()
    sample = _sampler(graphs)
    sample(_x())
    events = []
    graphs.events = events
    sample(_x())
    sample(_x())
    rec = graphs.recorder
    assert graphs.events is events and rec.on
    tree = _tree(rec)
    assert [n for n, _, _ in tree] == CHAIN + CHAIN
    for c, chain in enumerate((tree[:10], tree[10:])):
        assert chain[0] == ("chain", None, c + 1)
        assert all(p == "chain" and r == c + 1 for _, p, r in chain[1:])
    tags = [tag for name, *_, tag in rec.spans if name == "chain.launch"]
    assert [len(t) for t in tags] == [1, 3, 3] * 2
    assert all(b >= a for _, a, b, *_ in rec.spans)
    assert events == []  # on the CPU no replay is timed


@pytest.mark.parametrize("route", ["fit", "fit_scanned"])
def test_step_spans_nest_one_request_per_step(route):
    tr = _trainer()
    tr.graphs.events = []
    if route == "fit":
        tr.fit(3, metrics_hook=lambda s, m: None)
    else:
        tr.fit_scanned(3, lambda g: torch.randn((4, 3), generator=g),
                       chunk=2)
    tree = _tree(tr.recorder)
    steps = [r for n, _, r in tree if n == "step"]
    assert steps == [1, 2, 3]
    for name, parent, req in tree:
        if name != "step":
            assert parent == "step" and req in steps, name
    kids = [n for n, p, r in tree if r == 2 and n != "step"]
    assert kids == ["step.batch", "step.fill", "step.launch", "step.metrics"]
    if route == "fit_scanned":  # the host read closes each chunk of two
        assert [n for n, p, r in tree if r == 1 and n != "step"] == [
            "step.batch", "step.fill", "step.launch"]


def test_stop_keeps_the_record_until_the_next_start():
    graphs = GraphCache()
    sample = _sampler(graphs)
    graphs.events = []
    sample(_x())
    graphs.events = None
    rec = graphs.recorder
    kept = list(rec.spans)
    assert len(kept) == len(CHAIN) and graphs.events is None
    sample(_x())  # off: nothing more
    assert rec.spans == kept and not rec.on
    graphs.events = []
    assert rec.spans == []
    sample(_x())
    assert [s[0] for s in rec.spans] == CHAIN and rec.spans[0][4] == 1


def test_a_new_cache_leaves_the_first_recording():
    first = GraphCache()
    events = []
    first.events = events
    _sampler(first)(_x())
    second = GraphCache()
    _sampler(second)(_x())
    tr = _trainer()
    tr.fit(1)
    assert first.events is events and first.recorder.on
    assert [s[0] for s in first.recorder.spans] == CHAIN
    assert second.recorder.spans == [] and not second.recorder.on
    assert first.recorder in set(spans._REGISTRY)


def test_results_equal_with_recording_on_and_off():
    graphs = GraphCache()
    sample = _sampler(graphs)
    off = sample(_x())
    graphs.events = []
    on = sample(_x())
    assert torch.equal(off, on)
    a, b = _trainer(), _trainer()
    b.graphs.events = []
    a.fit(4)
    b.fit(4)
    for p, q in zip(a.state.model.parameters(), b.state.model.parameters()):
        assert torch.equal(p, q)
    assert b.recorder.spans


def test_profile_names_the_program_spans(tmp_path):
    """`debug.profile` turns every recorder's spans into named ranges of
    its trace, with recording off; `debug.trace` names one too."""
    graphs = GraphCache()
    sample = _sampler(graphs)
    sample(_x())
    with debug.profile(str(tmp_path)):
        with debug.trace("caller_phase"):
            sample(_x())
    assert graphs.recorder.spans == [] and not graphs.recorder.on
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"caller_phase", "chain", "chain.lookup", "chain.launch",
            "chain.output"} <= names


# -- the summary on synthetic device intervals ---------------------------

OFFSET = 1000.0  # the device clock: host seconds + OFFSET


class FakeEvent:
    """A timing event on a fake device clock (seconds)."""
    now = 0.0

    def __init__(self, t=None, **kw):
        self.t, self.done = t, True

    def record(self):
        self.t = FakeEvent.now

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _dev(h):
    return FakeEvent(h + OFFSET)


@pytest.fixture
def registry(monkeypatch):
    """A registry of its own, so other tests' recorders stay out."""
    reg = weakref.WeakSet()
    monkeypatch.setattr(spans, "_REGISTRY", reg)
    return reg


def _recorder(replays, rows, drift=0.0):
    """A recorder anchored at host 0 (device OFFSET) and host 20, whose
    replays are (host start, host end, request) and spans `rows`."""
    rec = spans.Recorder()
    rec.anchors = [(_dev(0.0), -1e-6, 1e-6), (_dev(20.0 - drift),
                                              20.0 - 2e-6, 20.0 + 2e-6)]
    rec.replays = [(s - 0.01, "chain/3", r, _dev(s), _dev(e))
                   for s, e, r in replays]
    rec.spans = [list(r) for r in rows]
    return rec


# chain 1 replays [1, 2] and [2.5, 3.5], chain 2 [6, 7]
REPLAYS = [(1.0, 2.0, 1), (2.5, 3.5, 1), (6.0, 7.0, 2)]
SPANS = [("chain", 0.5, 4.0, None, 1, None),
         ("chain.fill", 1.8, 2.6, 0, 1, None),
         ("chain", 5.0, 8.0, None, 2, None),
         ("chain.lookup", 5.0, 5.5, 2, 2, None)]


def test_summary_attributes_each_gap_second(registry):
    rec = _recorder(REPLAYS, SPANS, drift=3e-6)
    s = spans.summary(0.0, 10.0)
    assert s["replays"] == 3 and s["replay_s"] == pytest.approx(3.0)
    assert s["replay_s"] + s["gap_s"] == pytest.approx(10.0)
    by = s["gaps"]["by_span"]
    assert sum(by.values()) == pytest.approx(s["gap_s"])
    # [0, 1]: caller to 0.5, chain; [2, 2.5]: chain.fill; [3.5, 6]: chain
    # to 4, caller to 5, chain.lookup to 5.5, chain; [7, 10]: chain to 8
    assert by == pytest.approx({"caller": 0.5 + 1.0 + 2.0,
                                "chain": 0.5 + 0.5 + 0.5 + 1.0,
                                "chain.fill": 0.5, "chain.lookup": 0.5})
    longest = s["gaps"]["longest"]
    assert [g for g, _, _ in longest] == pytest.approx([3.0, 2.5, 1.0, 0.5])
    assert longest[0][1:] == ["caller", None]
    assert s["turns"]["chain"] == pytest.approx(
        {"count": 1, "median_ms": 2500.0, "max_ms": 2500.0})
    assert s["requests"]["chain"]["replay_ms_median"] == pytest.approx(
        1500.0)
    anchor, = s["anchors"]
    assert anchor["start_bracket_us"] == pytest.approx(2.0)
    assert anchor["stop_bracket_us"] == pytest.approx(4.0)
    assert anchor["drift_us"] == pytest.approx(3.0)
    table = s["spans"]
    assert table["chain"]["count"] == 2
    assert table["chain"]["host_s"] == pytest.approx(3.5 + 3.0)
    assert table["chain"]["self_s"] == pytest.approx(3.5 + 3.0 - 0.8 - 0.5)
    del rec


def test_summary_clips_to_the_window(registry):
    rec = _recorder(REPLAYS, SPANS)
    s = spans.summary(1.5, 6.5)
    assert s["window_s"] == pytest.approx(5.0)
    assert s["replay_s"] == pytest.approx(0.5 + 1.0 + 0.5)
    assert s["gap_s"] == pytest.approx(0.5 + 2.5)
    assert s["spans"]["chain"]["host_s"] == pytest.approx(2.5 + 1.5)
    assert s["spans"]["chain.fill"]["host_s"] == pytest.approx(0.8)
    assert s["gaps"]["by_span"] == pytest.approx(
        {"chain.fill": 0.5, "chain": 1.0, "caller": 1.0,
         "chain.lookup": 0.5})
    assert spans.summary(8.5, 9.0)["replays"] == 0
    del rec


def test_summary_of_nothing_is_none(registry):
    rec = spans.Recorder()
    assert spans.summary(0.0, 1.0) is None
    del rec


class FakeGraph:
    """A body of `splits` device seconds whose markers stamp the fake
    clock between them."""

    def __init__(self, markers, splits):
        self.markers, self.splits = markers, splits

    def replay(self):
        for (_, ev), d in zip(self.markers, self.splits):
            FakeEvent.now += d
            ev.t = FakeEvent.now
        FakeEvent.now += self.splits[-1]


def test_markers_sampled_reads_and_unread(registry, monkeypatch):
    """Each launch reads the body's previous replay if its end event has
    completed, else counts it unread; stop reads the last."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    markers = [("encode", FakeEvent())]
    graph = FakeGraph(markers, [0.001, 0.003])
    rec, events = spans.Recorder(), []
    rec.start(events)
    rec.replay(graph, "chain/3", markers)
    rec.replay(graph, "chain/3", markers)  # reads the first
    events[-1][1].done = False
    rec.replay(graph, "chain/3", markers)  # the second is not complete
    assert len(rec.reads) == 1 and len(rec.unread) == 1
    rec.stop()
    assert len(rec.reads) == 2 and len(events) == 3
    names, segs = rec.reads[0][3], rec.reads[0][4]
    assert names == ["encode", "end"]
    assert segs == pytest.approx([1.0, 3.0])
    s = spans.summary(-1e9, 1e9)
    m = s["markers"]["chain/3"]
    assert m["count"] == 2 and m["median_ms"] == pytest.approx([1.0, 3.0])
    assert m["replay_ms_median"] == pytest.approx(4.0)
    assert s["unread"] == 1
