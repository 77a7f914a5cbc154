"""The graphed chains (`tpu_diffusion_torch/sampling/graph.py`) on the CPU.

On a CPU tensor a graphed sampler runs its captured bodies in a Python
loop: the step reads its per-step values from device tables at the chain's
counter, its inputs from static buffers, and its noise is drawn before each
replay. Each graphed sampler is held bitwise against the eager loop with
the same generator; the graphed DDIM against the JAX jitted samplers with
the JAX noise handed in; the graphed MPNN decode against the loop and the
JAX draws; the cache's reuse and recapture; and `step_seed`'s low bits
(ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_protein_eval import (L, inputs, jax_decode_loop, t,  # noqa
                                     twins)
from torch_twin import TINY, jax_kernels, make_twins  # noqa: F401
from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.core.schedules import DDPM as JaxDDPM
from tpu_diffusion.sampling import ancestral as jax_ancestral
from tpu_diffusion_torch.cli import main as cli
from tpu_diffusion_torch.conditioning.guidance import Amortized, Replacement
from tpu_diffusion_torch.conditioning.likelihoods import InPainting
from tpu_diffusion_torch.core.schedules import DDPM, VPSDE
from tpu_diffusion_torch.models.unet import (UNetModel, UNetModelWrapper,
                                             randomize_)
from tpu_diffusion_torch.protein import denoiser as pden
from tpu_diffusion_torch.protein import mpnn
from tpu_diffusion_torch.protein import sde as psde
from tpu_diffusion_torch.protein.data import synthetic_ca_chains
from tpu_diffusion_torch.sampling import ancestral, ode, sde
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.train import trainer

DDIM_STEPS = 10
ANCESTRAL_STEPS = 25  # the DDPM of the ancestral chains (must exceed 20)
# The JAX comparison runs a 4-step grid (K=3: a head group of 1, then 3):
# both sides agree to ~1e-6 per forward (fp32, other summation orders), and
# x0 = sr * xi - srm1 * eps cancels two terms of up to ~50 at the grid's
# noisiest step (sr = 17 here, 150 on a 10-step grid), so the chains differ
# by 1.1e-5 to 2.1e-5 (measured; 3.7e-5 on the 10-step grid)
JAX_STEPS = 4
JAX_ATOL = 5e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _unet(in_channels=3, seed=0):
    m = UNetModel(**{**TINY, "in_channels": in_channels},
                  dtype=torch.float32, device="cpu")
    return randomize_(m, _gen(seed)).eval()


def _ddim_fns(model):
    def call(x, i, **kw):
        return model(x, i.float() / 1000, **kw)
    return (call, lambda x, i: call(x, i, mode="encode"),
            lambda x, i, c: call(x, i, mode="decode", cache=c))


def _ddim(model, k, eta, graphs=None, steps=DDIM_STEPS):
    eps, enc, dec = _ddim_fns(model)
    ddpm = DDPM.create(1000)
    if k == 1:
        return ancestral.make_ddim_sampler(eps, ddpm, steps, eta,
                                           graphs=graphs)
    return ancestral.make_cached_ddim_sampler(enc, dec, ddpm, steps, eta, k,
                                              graphs=graphs)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_ddim_graphed_equals_eager(k, eta):
    """K=1, K=3 and the non-dividing K=4 (a head group of 2), eta 0 and
    0.5: the graphed chain is the eager one, bit for bit, from one
    generator."""
    model = _unet()
    xT = torch.randn((2, 16, 16, 3), generator=_gen(1))
    graphs = GraphCache(model)
    want = _ddim(model, k, eta)(xT, _gen(2))
    got = _ddim(model, k, eta, graphs)(xT, _gen(2))
    assert torch.equal(got, want)
    chain, = graphs.chains.values()
    lengths = [len(g) for g in ancestral.reuse_groups(range(DDIM_STEPS), k)]
    assert {sig: n for sig, n in chain.replays.items()} == {
        (None,) * n: lengths.count(n) for n in set(lengths)}


@pytest.fixture(scope="module")
def unet_twins():
    mp = pytest.MonkeyPatch()
    try:
        with jax_kernels("xla", mp):
            jm, params, port = make_twins("xla", seed=7)
            xT = np.random.default_rng(8).standard_normal(
                (2, 16, 16, 3)).astype(np.float32)

            def call(x, i, **kw):
                return jm.apply(params, x, i.astype(jnp.float32) / 1000,
                                **kw)

            ddpm = JaxDDPM.create(1000)
            key = jax.random.PRNGKey(4)
            want = {
                1: jax.jit(jax_ancestral.make_ddim_sampler(
                    call, ddpm, num_steps=JAX_STEPS, eta=0.5))(key, xT),
                3: jax.jit(jax_ancestral.make_cached_ddim_sampler(
                    lambda x, i: call(x, i, mode="encode"),
                    lambda x, i, c: call(x, i, mode="decode", cache=c),
                    ddpm, num_steps=JAX_STEPS, eta=0.5, encoder_reuse=3))(
                        key, xT)}
            # the JAX chain's draws: per update, key, nk = split(key)
            noise = []
            for _ in range(JAX_STEPS):
                key, nk = jax.random.split(key)
                noise.append(np.asarray(jax.random.normal(nk, xT.shape)))
    finally:
        mp.undo()
    return port, xT, {k: np.asarray(v) for k, v in want.items()}, noise


@pytest.mark.parametrize("k", [1, 3])
def test_graphed_ddim_matches_jax(unet_twins, k):
    """The graphed DDIM (K=1, and K=3 with its head group) at eta 0.5,
    weights through convert.py and the JAX noise handed in, against the
    JAX package's jitted samplers."""
    port, xT, want, noise = unet_twins
    sample = _ddim(port, k, 0.5, GraphCache(port), steps=JAX_STEPS)
    got = sample(torch.from_numpy(xT),
                 noise=lambda like, kind, i, j=0: torch.tensor(noise[i]))
    np.testing.assert_allclose(got.numpy(), want[k], atol=JAX_ATOL, rtol=0)


def _ancestral_samplers(kind, graphs):
    """(sampler, takes a condition) for each graphed ancestral sampler,
    over a tiny UNet: 6 input channels (image and condition) where the
    conditioning is amortized."""
    ddpm = DDPM.create(ANCESTRAL_STEPS)
    lik = InPainting(patch_size=6, pad_value=-2.0)
    if kind == "prior":
        model = _unet()
        return ancestral.make_prior_sampler(
            _ddim_fns(model)[0], ddpm, graphs=graphs), False
    model = _unet(in_channels=6)
    eps, enc, dec = _ddim_fns(model)
    amortized = Amortized(n_corrector=1, delta=0.1)
    if kind == "prior_amortized":
        return ancestral.make_prior_sampler(eps, ddpm, amortized, lik,
                                            graphs=graphs), False
    if kind == "amortized":
        return ancestral.make_conditional_sampler(eps, ddpm, amortized, lik,
                                                  graphs=graphs), True
    if kind == "cached_amortized":
        return ancestral.make_cached_amortized_sampler(
            enc, dec, ddpm, amortized, lik, encoder_reuse=3,
            graphs=graphs), True
    model = _unet()
    return ancestral.make_conditional_sampler(
        _ddim_fns(model)[0], ddpm,
        Replacement(start_fraction=0.6, noise=True, n_corrector=1,
                    delta=0.1), lik, graphs=graphs), True


@pytest.mark.parametrize("kind", ["prior", "prior_amortized", "amortized",
                                  "cached_amortized", "replacement"])
def test_ancestral_graphed_equals_eager(kind):
    """Prior (plain and amortized), amortized with a corrector, the cached
    amortized K=3 (25 steps: a head group of 1), and noised replacement
    from step 15 down: the graphed chain is the eager one, bit for bit."""
    xT = torch.randn((2, 16, 16, 3), generator=_gen(3))
    lik = InPainting(patch_size=6, pad_value=-2.0)
    condition = lik.sample(_gen(4), torch.tanh(xT))
    outs = []
    for graphs in (None, GraphCache()):
        sample, conditional = _ancestral_samplers(kind, graphs)
        args = (xT, condition) if conditional else (xT,)
        outs.append(sample(*args, _gen(5)))
    assert torch.equal(outs[1], outs[0])


def _gaussian_score(x, t):
    """The exact score of N(0.5, 0.3^2) noised by the VP-SDE."""
    vp = VPSDE()
    s = vp.scale(t)[:, None, None, None]
    var = (s * 0.3) ** 2 + vp.sigma(t)[:, None, None, None] ** 2
    return -(x - s * 0.5) / var


@pytest.mark.parametrize("kind", ["euler_maruyama", "probability_flow",
                                  "predictor_corrector"])
def test_sde_graphed_equals_eager(kind):
    """The three SDE samplers over 25 steps, and the NaN flag."""
    xT = torch.randn((3, 4, 4, 2), generator=_gen(6))
    outs = []
    for graphs in (None, GraphCache()):
        kw = {"graphs": graphs}
        if kind == "euler_maruyama":
            outs.append(sde.euler_maruyama(_gen(7), _gaussian_score, VPSDE(),
                                           xT, 25, True, **kw))
        elif kind == "probability_flow":
            outs.append((sde.probability_flow(_gaussian_score, VPSDE(), xT,
                                              25, **kw),))
        else:
            outs.append(sde.predictor_corrector(
                _gen(7), _gaussian_score, VPSDE(), xT, 25, 2, 0.16, True,
                **kw))
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_ode_graphed_equals_eager(method):
    """The four fixed-step integrators over a tiny CFM UNet: x1 bit for bit
    and the NFE."""
    v = UNetModelWrapper((16, 16, 3), num_channels=16, num_res_blocks=1,
                         channel_mult=(1, 2), num_heads=2,
                         attention_resolutions="8", dtype=torch.float32,
                         device="cpu")
    randomize_(v, _gen(8)).eval()
    x0 = torch.randn((2, 16, 16, 3), generator=_gen(9))
    with torch.no_grad():
        want = ode.odeint(v, x0, method, num_steps=5)
        got = ode.odeint(v, x0, method, num_steps=5, graphs=GraphCache(v))
    assert got[1] == want[1] and torch.equal(got[0], want[0])


def test_unguided_protein_chain_graphed_equals_eager():
    """The unguided reverse chain of a tiny GVP denoiser over 20 steps on
    ragged chains: every step's COM-free noise drawn before its replay, the
    last three steps noise-free; bit for bit."""
    n = 24
    model = pden.GVPDenoiser(max_protein_length=n, n_h_node_feats=(16, 4),
                             n_h_edge_feats=(16, 4), n_conv_layers=1,
                             num_steps=20, device="cpu").eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=_gen(10)))
    ds = synthetic_ca_chains(3, max_len=n, min_len=8, seed=1)
    mask = torch.from_numpy(np.arange(n)[None] < ds.lengths[:, None])
    diffuser = psde.HoogeboomGraphSDE(num_steps=20)
    blob = diffuser.sample_blob(_gen(11), 3, n,
                                lengths=torch.from_numpy(ds.lengths))
    outs = [diffuser.reverse_diffusion_sampling(
        _gen(12), blob, model, graphs=graphs).pos
        for graphs in (None, GraphCache(model))]
    assert torch.equal(outs[1], outs[0]) and torch.isfinite(outs[0]).all()
    assert bool((outs[0][~mask] == 0).all())


@pytest.mark.parametrize("motif", [False, True])
def test_graphed_mpnn_decode_replays_jax(twins, motif):
    """The device-indexed decode (position order[t] read on the device, one
    body for every order of length L) equals the loop token for token and
    replays the JAX order and Gumbel draws; with a second order through the
    same graph."""
    jm, params, port = twins
    coords, mask, _, order = inputs(seed=2)
    init = np.zeros(L, np.int32)
    fixed = np.zeros(L, np.float32)
    if motif:
        idx = [2, 5, 9]
        init[idx] = [18, 6, 19]
        fixed[idx] = 1.0
        order = np.concatenate([order[np.isin(order, idx)],
                                order[~np.isin(order, idx)]])
    want, noise = jax_decode_loop(jm, params, coords, mask, order, init,
                                  fixed, jax.random.PRNGKey(3), 0.1)
    graphs = GraphCache(port)
    _, loop = mpnn.make_mpnn_fns(port)
    _, graphed = mpnn.make_mpnn_fns(port, graphs)
    args = (t(coords), order, t(mask), t(init), t(fixed), 0.1)
    got = graphed(*args, noise=t(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, loop(*args, noise=t(noise)))
    other = np.random.default_rng(5).permutation(L)
    args = (t(coords), other, t(mask), t(init), t(fixed), 0.1)
    assert torch.equal(graphed(*args, generator=_gen(6)),
                       loop(*args, generator=_gen(6)))
    assert graphs.captures == 1


def test_graph_cache_reuses_and_recaptures():
    """A second call at the same shape reuses the chain; a new shape adds
    one; reallocated parameters, or parameters changed in place (the
    periodic evals' set_params), capture again, and the chain then
    samples the new weights."""
    model = _unet()
    graphs = GraphCache(model)
    sample = _ddim(model, 3, 0.0, graphs)
    xT = torch.randn((2, 16, 16, 3), generator=_gen(1))
    first = sample(xT)
    assert torch.equal(sample(xT), first)
    assert graphs.captures == 1 and len(graphs.chains) == 1
    sample(torch.randn((1, 16, 16, 3), generator=_gen(2)))
    assert graphs.captures == 2 and len(graphs.chains) == 2
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    assert torch.equal(sample(xT), first)
    assert graphs.captures == 3 and len(graphs.chains) == 2
    with torch.no_grad():
        model.conv_out.weight.mul_(1.5)
    got = sample(xT)
    assert graphs.captures == 4 and not torch.equal(got, first)
    assert torch.equal(got, _ddim(model, 3, 0.0)(xT))
    graphs.clear()
    assert not graphs.chains


def test_cli_samplers_keep_their_graphs():
    """`make_samplers` keeps the model's graphed samplers across calls and
    captures again after `set_params`, equal to the eager samplers."""
    config = cli.get_config("mnist,inpainting,amortized")
    cli.apply_overrides(config, [
        "diffusion.num_steps=25", "network.dtype=float32",
        "network.num_channels=16", "network.num_head_channels=16",
        "testing.encoder_reuse=3"])
    torch.manual_seed(0)
    parts = cli.build(config, torch.device("cpu"))
    model = parts["model"].eval()
    cond_sample, _ = cli.make_samplers(config, parts)
    eager_sample, _ = cli.make_samplers(config, parts, graphed=False)
    lik = parts["likelihood"]
    imgs = torch.tanh(torch.randn((2, 28, 28, 1), generator=_gen(1)))
    cond = lik.sample(_gen(2), imgs)
    xT = torch.randn(imgs.shape, generator=_gen(3))
    a = cond_sample(model, xT, cond, _gen(4))
    b = cond_sample(model, xT, cond, _gen(4))
    graphs = cond_sample.built["graphs"]
    assert torch.equal(a, b) and graphs.captures == 1
    assert torch.equal(a, eager_sample(model, xT, cond, _gen(4)))
    cli.set_params(model, {name: 0.9 * p.detach() for name, p
                           in model.named_parameters()})
    c = cond_sample(model, xT, cond, _gen(4))
    assert graphs.captures == 2
    assert torch.equal(c, eager_sample(model, xT, cond, _gen(4)))


def test_step_seed_low_bits_follow_the_base_seed():
    """C3: on the CPU (whose generator reads a seed's low 32 bits) two base
    seeds draw different batches at every step, and the seeds stay
    distinct across steps."""
    for step in (0, 1, 7):
        a, b = (torch.rand(4, generator=_gen(trainer.step_seed(s, step)))
                for s in (0, 1))
        assert not torch.equal(a, b)
    seeds = {trainer.step_seed(s, k) & 0xFFFFFFFF
             for s in range(4) for k in range(64)}
    assert len(seeds) == 256
