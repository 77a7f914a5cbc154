"""The graphed chains (`tpu_diffusion_torch/sampling/graph.py`) on the card:
graph replay against the eager chain, at a small size.

These tests need a CUDA card and skip without one (a capture has no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py
"""

import time

import pytest
import torch

from tpu_diffusion_torch.conditioning.guidance import ReconstructionGuidance
from tpu_diffusion_torch.conditioning.likelihoods import InPainting
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.kernels import launch_counts
from tpu_diffusion_torch.models.unet import (UNetModelWrapper, create_model,
                                             randomize_)
from tpu_diffusion_torch.models.unet_infer import make_fused_apply
from tpu_diffusion_torch.protein import mpnn
from tpu_diffusion_torch.sampling import ancestral, ode
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.utils import spans

STEPS = 12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cifar(cuda):
    """The bench UNet (128 channels, (1,2,2,2), attention at 16x16 with 4
    heads, FiLM, bf16) with the GN kernel, random weights, and its
    fused-inference engine."""
    model = create_model(image_size=32, num_channels=128, num_res_blocks=2,
                         in_channels=3, channel_mult=(1, 2, 2, 2),
                         num_heads=4, attention_resolutions="16",
                         use_scale_shift_norm=True, dtype=torch.bfloat16,
                         attention_impl="fused", norm_impl="fused",
                         device=cuda)
    randomize_(model, torch.Generator().manual_seed(0))
    return model.eval(), make_fused_apply(model.eval())


def _samplers(fn, k, eta, graphs):
    def call(x, i, **kw):
        return fn(x, i.float() / 1000.0, **kw)
    ddpm = DDPM.create(1000)
    if k == 1:
        return ancestral.make_ddim_sampler(call, ddpm, STEPS, eta,
                                           graphs=graphs)
    return ancestral.make_cached_ddim_sampler(
        lambda x, i: call(x, i, mode="encode"),
        lambda x, i, c: call(x, i, mode="decode", cache=c), ddpm, STEPS, eta,
        k, graphs=graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("path", ["engine", "model"])
def test_cuda_graphed_ddim_equals_eager(cifar, cuda, path, k, eta):
    """DDIM at batch 8: the graphed chain equals the eager one bitwise (no
    kernel on the path sums with atomics), and the replays launch what the
    eager chain launches."""
    model, engine = cifar
    fn = engine if path == "engine" else model
    xT = torch.randn((8, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(1)).to(cuda)
    graphs = GraphCache(model)
    _samplers(fn, k, eta, None)(xT, torch.Generator(cuda).manual_seed(2))
    before = launch_counts()
    want = _samplers(fn, k, eta, None)(
        xT, torch.Generator(cuda).manual_seed(2))
    eager = {name: n - before[name] for name, n in launch_counts().items()
             if n != before[name]}
    got = _samplers(fn, k, eta, graphs)(
        xT, torch.Generator(cuda).manual_seed(2))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert graphs.replayed_launches() == eager
    assert eager["flash_attention_fused"] > 0
    assert eager["fused_groupnorm_silu"] > 0
    if path == "engine":
        assert eager["fused_resblock"] > 0


@pytest.mark.cuda
def test_cuda_marked_chain_equals_eager_and_its_splits_add_up(cifar, cuda):
    """K=3 through the engine with the recorder on: the chain, whose group
    body holds the "encode" marker, equals the eager one bitwise; each
    sampled replay's marker splits add up to its event time within 20 us,
    and the summary's replay and gap seconds fill its window."""
    model, engine = cifar
    xT = torch.randn((8, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(4)).to(cuda)
    want = _samplers(engine, 3, 0.5, None)(
        xT, torch.Generator(cuda).manual_seed(5))
    graphs = GraphCache(model)
    sample = _samplers(engine, 3, 0.5, graphs)
    sample(xT, torch.Generator(cuda).manual_seed(6))  # captures
    events = []
    graphs.events = events
    t0 = time.perf_counter()
    got = sample(xT, torch.Generator(cuda).manual_seed(5))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    graphs.events = None
    assert torch.equal(got, want)
    chain, = graphs.chains.values()
    assert [[n for n, _ in m] for m in chain.markers.values()] == [
        ["encode"]]
    rec = graphs.recorder
    assert len(events) == STEPS // 3 and rec.reads
    replays = {t: (s, e) for t, _, _, s, e in rec.replays}
    for t, label, _, names, segs in rec.reads:
        s, e = replays[t]
        assert label == "chain/3" and names == ["encode", "end"]
        assert min(segs) > 0
        assert abs(sum(segs) - s.elapsed_time(e)) <= 0.020
    got = spans.summary(t0, t1)
    assert got["replays"] == STEPS // 3
    assert got["replay_s"] + got["gap_s"] == pytest.approx(t1 - t0,
                                                           abs=50e-6)
    assert sum(got["gaps"]["by_span"].values()) == pytest.approx(
        got["gap_s"])


@pytest.mark.cuda
def test_cuda_graph_cache_recaptures_after_an_update(cifar, cuda):
    """A parameter changed in place reallocates the model's bf16 cast
    copies: the chain is captured again and samples the new weights."""
    model, _ = cifar
    xT = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(3)).to(cuda)
    graphs = GraphCache(model)
    sample = _samplers(model, 3, 0.0, graphs)
    first = sample(xT)
    assert torch.equal(sample(xT), first) and graphs.captures == 1
    with torch.no_grad():
        model.conv_out.weight.mul_(1.5)
    try:
        got = sample(xT)
        assert graphs.captures == 2
        assert torch.equal(got, _samplers(model, 3, 0.0, None)(xT))
    finally:
        with torch.no_grad():
            model.conv_out.weight.div_(1.5)


@pytest.mark.cuda
def test_cuda_graphed_euler_equals_eager(cuda):
    """Euler-20 over a small CFM UNet (the flash kernels at T=1024)."""
    v = UNetModelWrapper((32, 32, 3), num_channels=64, num_res_blocks=1,
                         channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="32", attention_impl="flash",
                         dtype=torch.bfloat16, device=cuda)
    randomize_(v, torch.Generator().manual_seed(4)).eval()
    x0 = torch.randn((2, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(5)).to(cuda)
    with torch.no_grad():
        want = ode.odeint(v, x0, "euler", num_steps=20)
        got = ode.odeint(v, x0, "euler", num_steps=20, graphs=GraphCache(v))
    assert got[1] == want[1] and torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_cuda_graphed_mpnn_decode_equals_the_loop(cuda):
    """The published-width MPNN at random weights on a 60-residue chain:
    the graphed design is the loop's, token for token, for two orders."""
    model = mpnn.CAProteinMPNN(device=cuda)
    model.randomize_(torch.Generator(cuda).manual_seed(0))
    model.eval()
    g = torch.Generator().manual_seed(6)
    steps = torch.randn((60, 3), generator=g)
    coords = (3.8 * torch.cumsum(steps / steps.norm(dim=-1, keepdim=True),
                                 0)).to(cuda)
    graphs = GraphCache(model)
    _, loop = mpnn.make_mpnn_fns(model)
    _, graphed = mpnn.make_mpnn_fns(model, graphs)
    for seed in (1, 2):
        order = torch.randperm(60, generator=torch.Generator()
                               .manual_seed(seed))
        args = (coords, order, coords.new_ones(60),
                torch.zeros(60, dtype=torch.long), torch.zeros(60))
        want = loop(*args, generator=torch.Generator(cuda).manual_seed(seed))
        got = graphed(*args,
                      generator=torch.Generator(cuda).manual_seed(seed))
        assert torch.equal(got, want)
    assert graphs.captures == 1


def _guided_chains(cuda, norm_impl):
    """(graphed chain, eager chain, first eager chain, its cache, the eager
    chain's kernel launches) of the reconstruction-guidance chain over a
    small fp32 UNet with `norm_impl`, cuDNN deterministic."""
    model = create_model(image_size=32, num_channels=32, num_res_blocks=1,
                         in_channels=3, channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="32", dtype=torch.float32,
                         attention_impl="flash", norm_impl=norm_impl,
                         device=cuda)
    randomize_(model, torch.Generator().manual_seed(7))
    model.eval().requires_grad_(False)

    def eps(x, i):
        return model(x, i.float() / 25)

    ddpm = DDPM.create(25)
    lik = InPainting(patch_size=12, pad_value=-2.0)
    g = torch.Generator().manual_seed(8)
    xT = torch.randn((4, 32, 32, 3), generator=g).to(cuda)
    cond = lik.sample(g, torch.tanh(xT).cpu()).to(cuda)
    guidance = ReconstructionGuidance(gamma=10.0, start_fraction=0.5,
                                      n_corrector=1, delta=0.1)
    graphs = GraphCache(model)

    def run(graphs):
        return ancestral.make_conditional_sampler(
            eps, ddpm, guidance, lik, graphs=graphs)(
                xT, cond, torch.Generator(cuda).manual_seed(9))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        first = run(None)
        before = launch_counts()
        want = run(None)
        eager = {name: n - before[name]
                 for name, n in launch_counts().items() if n != before[name]}
        got = run(graphs)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return got, want, first, graphs, eager


@pytest.mark.cuda
def test_cuda_graphed_guidance_equals_eager(cuda):
    """The reconstruction-guidance chain (25 steps, half guided, one
    corrector) over a small fp32 UNet with flash attention at T=1024: the
    guided body differentiates inside its capture, the chain equals the
    eager one bitwise, and the replays launch the flash backward as often
    as the eager chain. The fp32 flash backward sums with no atomics;
    cuDNN's default backward-data algorithms do (two eager gradients
    differ by ~7e-7, which gamma 10 amplifies), so the test takes its
    deterministic ones."""
    got, want, first, graphs, eager = _guided_chains(cuda, "plain")
    assert torch.equal(got, want) and torch.equal(want, first)
    assert graphs.replayed_launches() == eager
    assert eager["flash_attention_bwd"] > 0


@pytest.mark.cuda
def test_cuda_graphed_guidance_through_the_gn_kernel(cuda):
    """The same chain with the GroupNorm kernel (as `cli.main.build` gives
    it on the card): the guidance gradient with respect to x alone (the
    parameters need none) runs the GN backward kernel, whose sums take no
    atomics, so the graphed chain still equals the eager one bitwise."""
    got, want, first, graphs, eager = _guided_chains(cuda, "fused")
    assert torch.equal(got, want) and torch.equal(want, first)
    assert graphs.replayed_launches() == eager
    assert eager["fused_groupnorm_silu_bwd"] > 0
    assert eager["fused_groupnorm_silu"] > eager["fused_groupnorm_silu_bwd"]


@pytest.mark.cuda
def test_cuda_graphed_dopri5_equals_the_eager_loop(cuda):
    """dopri5's early exit over a small CFM UNet: the graphed chain (a
    one-trip body replayed, `done` read after each replay) ends with the
    eager loop's x, bitwise, and NFE."""
    v = UNetModelWrapper((32, 32, 3), num_channels=32, num_res_blocks=1,
                         channel_mult=(1, 2), num_heads=1,
                         attention_resolutions="16", dtype=torch.float32,
                         device=cuda)
    randomize_(v, torch.Generator().manual_seed(10)).eval()
    v.requires_grad_(False)
    x0 = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(11)).to(cuda)
    with torch.no_grad():
        want = ode.odeint_dopri5(v, x0, rtol=1e-3, atol=1e-3, max_steps=60)
        graphs = GraphCache(v)
        got = ode.odeint_dopri5(v, x0, rtol=1e-3, atol=1e-3, max_steps=60,
                                graphs=graphs)
    assert got[1] == want[1] and torch.equal(got[0], want[0])
    assert graphs.captures == 1


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda):
    """A body that reads the card on the host cannot be captured: the
    sampler raises, and does not fall back to the eager loop. The failed
    capture leaves the current stream as it was and the default generator
    out of capture mode: the card draws as before."""
    def eps(x, i):
        return x * float(i[0])  # a host read inside the body

    sample = ancestral.make_ddim_sampler(eps, DDPM.create(1000), 4,
                                         graphs=GraphCache())
    stream = torch.cuda.current_stream(cuda)
    torch.manual_seed(12)
    want = torch.randn(4, device=cuda)
    torch.manual_seed(12)
    with pytest.raises(RuntimeError):
        sample(torch.zeros((2, 8, 8, 3), device=cuda))
    assert torch.cuda.current_stream(cuda) == stream
    assert torch.equal(torch.randn(4, device=cuda), want)
