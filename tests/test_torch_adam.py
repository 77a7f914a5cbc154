"""The fused clip + Adam + EMA update (`kernels/adam.py`) on the CPU: its
plain version against the optimizer's foreach body and `ema_blend`, the
optimizer's fused route with the plain version in the kernel's place, the
route chooser, the chunk table and the wrapper's checks. The kernel itself
runs on the card only (`tests/test_torch_cuda_adam.py`)."""

import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.core.ema import EMAState, ema_blend
from tpu_diffusion_torch.kernels import adam
from tpu_diffusion_torch.models.unet import create_model, randomize_
from tpu_diffusion_torch.train import trainer

STEPS = 3
CLIP = 1.0
RAMP = 2.0 / 11.0  # ema_fill's warm-up ramp at its first call


def _model(seed=0):
    model = create_model(image_size=16, num_channels=16, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=2,
                         attention_resolutions="8",
                         use_scale_shift_norm=True, device="cpu")
    randomize_(model, torch.Generator().manual_seed(seed))
    return model


def _grads(model, step, scale):
    """Seeded gradients of every parameter, their global norm about
    `scale` times the square root of the parameter count."""
    gen = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=gen) * scale
            for p in model.parameters()]


def _weights(ema, d):
    ema.decay.fill_(d)
    ema.rest.fill_(1.0 - d)


def _ulps(a, b):
    """The largest distance of `a` from `b` in fp32 units in the last
    place, +0 and -0 taken as one value."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


@pytest.mark.parametrize("d", [0.0, 1.0, RAMP], ids=["copy", "keep", "ramp"])
@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_reference_equals_foreach_body_and_ema_blend(scale, d):
    """`adam_ema_reference` (through `fused_adam_ema`, which takes it for
    CPU tensors) over three steps equals the optimizer's foreach body
    followed by `ema_blend`, bitwise: tolerance 0 units in the last place
    (+0 and -0 as one), since it runs the same ops in the same order, the
    gradients left unclipped and the EMA's keep and copy taken as
    branches."""
    want_model, got_model = _model(), _model()
    opt = trainer.make_optimizer(want_model.parameters(), 1e-3, warmup=2,
                                 grad_clip=CLIP)
    want_ema = EMAState(dict(want_model.named_parameters()))
    got = list(got_model.parameters())
    got_m = [torch.zeros_like(p) for p in got]
    got_v = [torch.zeros_like(p) for p in got]
    got_ema = EMAState(dict(got_model.named_parameters()))
    engaged = []
    for step in range(STEPS):
        grads = _grads(want_model, step, scale)
        for p, g in zip(want_model.parameters(), grads):
            p.grad = g.clone()
        opt.fill()
        _weights(want_ema, d)
        _weights(got_ema, d)
        gnorm = opt.update()
        ema_blend(want_ema, dict(want_model.named_parameters()))
        engaged.append(float(gnorm) > CLIP)
        factor = CLIP / torch.clamp(gnorm, min=CLIP)
        adam.fused_adam_ema(
            got, grads, got_m, got_v, list(got_ema.params.values()),
            opt.scalars["lr"], opt.scalars["bc1"], opt.scalars["bc2"],
            factor, got_ema.decay, got_ema.rest, opt.B1, opt.B2, opt.EPS)
    assert all(engaged) == (scale == 1.0) and any(engaged) == all(engaged)
    for (name, p), q, m, v in zip(want_model.named_parameters(), got, got_m,
                                  got_v):
        state = opt.state[p]
        assert _ulps(q, p) == 0, name
        assert _ulps(m, state["exp_avg"]) == 0, name
        assert _ulps(v, state["exp_avg_sq"]) == 0, name
        assert _ulps(got_ema.params[name], want_ema.params[name]) == 0, name
    if d == 1.0:  # kept: the EMA is still the initial parameters, bitwise
        for name, p in _model().named_parameters():
            assert torch.equal(got_ema.params[name], p), name


def test_fused_route_equals_foreach_route(monkeypatch):
    """The optimizer's "fused" route, forced on the CPU (where
    `fused_adam_ema` takes the plain version), gives the foreach route's
    parameters, moments and EMA bitwise over three steps of
    `TrainStep`-like updates: the EMA paired with the parameters by
    identity, a parameter with no gradient left alone by Adam and its EMA
    entry still blended through `ema_blend`; the fused route leaves the
    gradients unclipped."""
    runs = {}
    for route in ("foreach", "fused"):
        with monkeypatch.context() as mp:
            mp.setattr(trainer.Optimizer, "route", property(
                lambda self, r=route: r))
            model = _model()
            opt = trainer.make_optimizer(model.parameters(), 1e-3,
                                         grad_clip=CLIP)
            ema = EMAState(dict(model.named_parameters()))
            frozen = next(iter(model.parameters()))
            raw = []
            for step, d in enumerate((0.0, RAMP, 1.0)):
                grads = _grads(model, step, 1.0)
                for p, g in zip(model.parameters(), grads):
                    p.grad = None if p is frozen else g.clone()
                opt.fill()
                _weights(ema, d)
                opt.blend(ema, dict(model.named_parameters()))
                opt.update()
                raw.append([p.grad.clone() for p in model.parameters()
                            if p is not frozen])
            runs[route] = (model, opt, ema, grads, raw)
    (fm, fo, fe, grads, _), (gm, go, ge, _, raw) = (runs["foreach"],
                                                     runs["fused"])
    assert go._ema[0] is ge and len(go._ema[2]) == len(go.params)
    first = next(iter(fm.parameters()))
    assert first not in fo.state
    assert next(iter(gm.parameters())) not in go.state
    assert torch.equal(first, next(iter(_model().parameters())))
    for (name, p), q in zip(fm.named_parameters(), gm.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(fe.params[name], ge.params[name]), name
        if p in fo.state:
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(fo.state[p][key], go.state[q][key]), name
    # the fused route's gradients are the raw ones, not clipped
    assert len(raw[-1]) == len(grads) - 1
    assert all(torch.equal(a, b) for a, b in zip(raw[-1], grads[1:]))


def test_blend_pairs_once_per_ema_state():
    """`blend` pairs an EMA state's tensors with the optimizer's
    parameters by identity once, and again only for another state."""
    model = _model()
    opt = trainer.make_optimizer(model.parameters(), 1e-3)
    ema = EMAState(dict(model.named_parameters()))
    opt.blend(ema, dict(model.named_parameters()))
    paired = opt._ema
    opt.blend(ema, dict(model.named_parameters()))
    assert opt._ema is paired
    for name, p in model.named_parameters():
        assert paired[2][id(p)] is ema.params[name]
    other = EMAState(dict(model.named_parameters()))
    opt.blend(other, dict(model.named_parameters()))
    assert opt._ema[0] is other


@pytest.mark.parametrize("device,dtype,route", [
    ("cuda", torch.float32, "fused"),
    (torch.device("cuda", 1), torch.float32, "fused"),
    ("cuda", torch.bfloat16, "foreach"),
    ("cuda", torch.float16, "foreach"),
    ("cpu", torch.float32, "foreach"),
    ("cpu", torch.bfloat16, "foreach"),
])
def test_route_chooser(device, dtype, route):
    """The kernel for fp32 on a CUDA device, the foreach body for any other
    type and for the CPU; no card needed to choose."""
    assert adam.adam_route(device, dtype) == route


def test_optimizer_route_on_the_cpu():
    """On the CPU the optimizer takes the foreach body, fp32 or mixed."""
    model = _model()
    assert trainer.make_optimizer(model.parameters(), 1e-3).route == "foreach"
    mixed = [torch.zeros(4, requires_grad=True),
             torch.zeros(4, dtype=torch.bfloat16, requires_grad=True)]
    assert trainer.make_optimizer(mixed, 1e-3).route == "foreach"


@pytest.mark.parametrize("numels,chunk", [
    ([1, 2, 3, 5, 7], 8),                     # all smaller than a chunk
    ([8, 16, 24], 8),                         # whole chunks
    ([9, 17, 31, 33, 1], 8),                  # ragged tails
    ([0, 6, 0, 13], 4),                       # empty tensors
    ([adam.CHUNK * 3 + 5, 1000, 3, adam.CHUNK], adam.CHUNK),
])
def test_chunk_table_covers_every_element_once(numels, chunk):
    """Every element of every tensor in exactly one chunk; chunks start at
    multiples of the chunk size (so of 4: the kernel's float4 accesses stay
    aligned), hold 1 to `chunk` elements, and come longest first."""
    rows = adam.chunk_table(numels, chunk)
    seen = [torch.zeros(n, dtype=torch.int64) for n in numels]
    for i, start, length in rows:
        assert start % chunk == 0 and 0 < length <= chunk
        seen[i][start:start + length] += 1
    assert all(bool((s == 1).all()) for s in seen)
    lengths = [r[2] for r in rows]
    assert lengths == sorted(lengths, reverse=True)
    assert len(rows) == sum(-(-n // chunk) for n in numels)


def test_chunk_table_of_a_unet():
    """The tiny UNet's parameters: one chunk per tensor, whatever their
    lengths (some not a multiple of 4)."""
    numels = [p.numel() for p in _model().parameters()]
    assert any(n % 4 for n in numels)
    rows = adam.chunk_table(numels)
    assert len(rows) == sum(-(-n // adam.CHUNK) for n in numels)
    assert sorted({r[0] for r in rows}) == list(range(len(numels)))


def test_chunk_table_refuses_a_chunk_not_a_multiple_of_4():
    with pytest.raises(ValueError, match="multiple of 4"):
        adam.chunk_table([10], 6)


def _lists(n=3):
    ps = [torch.zeros(5 + k) for k in range(n)]
    return [ps] + [[torch.zeros_like(p) for p in ps] for _ in range(4)]


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "length", "count"])
def test_wrapper_checks_refuse(fault):
    """The wrapper's checks (run before a launch) refuse a tensor of another
    type, a strided one, one of another length, and lists of unequal
    lengths."""
    lists = _lists()
    if fault == "dtype":
        lists[1][0] = lists[1][0].to(torch.bfloat16)
    elif fault == "contiguity":
        lists[2][1] = torch.zeros(12)[::2]
    elif fault == "length":
        lists[3][2] = torch.zeros(99)
    else:
        lists[4] = lists[4][:2]
    one = torch.ones(())
    with pytest.raises(ValueError):
        adam._check(torch.device("cpu"), lists, dict(lr=one, bc1=one,
                                                     bc2=one))


def test_wrapper_checks_pass_and_take_missing_emas():
    lists = _lists()
    lists[4][1] = None
    one = torch.ones(())
    adam._check(torch.device("cpu"), lists, dict(lr=one, bc1=one, bc2=one,
                                                 clip=None))
    with pytest.raises(ValueError, match="0-d fp32"):
        adam._check(torch.device("cpu"), lists,
                    dict(lr=torch.ones(2), bc1=one, bc2=one))
