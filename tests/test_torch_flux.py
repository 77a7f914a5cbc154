"""FLUX.1 Fill [dev]'s transformer (`tpu_diffusion_torch/models/flux.py`)
on the CPU, at tiny widths, against the benchmark's plain reference
(`benchmark/reference/flux.py`) on the same seeded weights; the published
parameter count; the latent and mask packing; RoPE; the shifted sigma
grid; and the flow-matching path it samples on (`sampling/ode.py`: an
explicit grid, bitwise the default where it is the default's, the Fill
condition by concatenation, and the graphed CPU chain against the eager
one)."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import flux as ref_mod
from tests.torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.models import flux
from tpu_diffusion_torch.sampling import ode
from tpu_diffusion_torch.sampling.graph import GraphCache

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                     / "configs" / "flux1-fill-dev.json").read_text())
TINY = dict(patch_size=1, in_channels=384, out_channels=64, num_layers=1,
            num_single_layers=2, attention_head_dim=16,
            num_attention_heads=2, joint_attention_dim=32,
            pooled_projection_dim=16, guidance_embeds=True,
            axes_dims_rope=[4, 6, 6])
# the scheduler config's dynamic-shift keys, as `shifted_sigmas` takes them
SHIFT = {k: CONFIG["scheduler"][k] for k in (
    "base_image_seq_len", "max_image_seq_len", "base_shift", "max_shift")}
SEED = 2 ** 33 + 25
HW = (4, 4)  # token grid: an 8x8 latent, a 64x64 image
TEXT = 8


@pytest.fixture(scope="module")
def pair():
    """(the port's fp32 FluxTransformer, the reference), one seed's
    weights."""
    port = flux.create_flux(dtype=torch.float32, device="cpu", **TINY)
    ref_mod.load_weights(port, TINY, SEED, "cpu")
    ref = ref_mod.reference_flux(TINY, SEED, "cpu")
    return port.eval().requires_grad_(False), ref


def _inputs(b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, HW[0] * HW[1], 384), generator=g)
    ctx = torch.randn((b, TEXT, 32), generator=g)
    pooled = torch.randn((b, 16), generator=g)
    return x, ctx, pooled


def test_published_parameter_count_and_names():
    model = flux.create_flux(device="meta", **CONFIG["model"])
    assert sum(p.numel() for p in model.parameters()) == \
        CONFIG["parameters"] == 11_902_391_360
    assert len(model.transformer_blocks) == 19
    assert len(model.single_transformer_blocks) == 38
    with torch.device("meta"):
        ref = ref_mod.Flux(CONFIG["model"])
    names = [n for n, _ in model.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    for name in ("transformer_blocks.0.attn.add_q_proj.weight",
                 "transformer_blocks.18.attn.norm_added_k.weight",
                 "transformer_blocks.0.ff_context.net.2.bias",
                 "single_transformer_blocks.0.proj_mlp.weight",
                 "single_transformer_blocks.37.attn.norm_q.weight",
                 "time_text_embed.guidance_embedder.linear_1.weight",
                 "norm_out.linear.weight", "proj_out.bias"):
        assert name in names
    assert next(model.parameters()).dtype == torch.bfloat16


@pytest.mark.parametrize("sigma,guidance", [(0.9, 30.0), (0.05, 3.5)])
def test_forward_matches_reference(pair, sigma, guidance):
    """fp32 on both sides, the same weights: the port's forward (fused
    modulation, F.rms_norm, RoPE as a complex product, attention through
    the flash forward's plain version) against the reference written out
    term by term. Both compute in fp32 with sums in other orders: 1e-5 of
    the output's scale."""
    port, ref = pair
    x, ctx, pooled = _inputs()
    with torch.no_grad():
        got = port(x, torch.tensor([sigma] * 2),
                   torch.tensor([guidance] * 2), ctx, pooled, HW)
        want = ref(x, sigma, guidance, ctx, pooled, HW)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_rows_are_independent(pair):
    """Each row's timestep and inputs are its own."""
    port, ref = pair
    x, ctx, pooled = _inputs()
    with torch.no_grad():
        got = port(x, torch.tensor([0.9, 0.2]), torch.tensor([30.0, 4.0]),
                   ctx, pooled, HW)
        want = ref(x[1:], 0.2, 4.0, ctx[1:], pooled[1:], HW)
    torch.testing.assert_close(got[1:], want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_bf16_forward_near_reference(pair):
    """The bf16 model (the card's type) within bf16's rounding of the fp32
    reference: a mean relative gap of a few 2^-8."""
    _, ref = pair
    port = flux.create_flux(dtype=torch.bfloat16, device="cpu", **TINY)
    ref_mod.load_weights(port, TINY, SEED, "cpu")
    x, ctx, pooled = _inputs()
    with torch.no_grad():
        got = port(x, torch.tensor([0.5, 0.5]), torch.tensor([30.0, 30.0]),
                   ctx, pooled, HW)
        want = ref(x, 0.5, 30.0, ctx, pooled, HW)
    gap = (got - want).abs().mean() / want.abs().mean()
    assert gap < 0.03, gap


def test_decisions_and_kinds(pair):
    port, _ = pair
    x, ctx, pooled = _inputs(b=1)
    with torch.no_grad():
        port(x, torch.tensor([0.5]), torch.tensor([30.0]), ctx, pooled, HW)
    d = port.attn_decisions
    assert [v["kind"] for v in d.values()] == ["double", "single", "single"]
    assert all(v["route"] == "plain" and v["t"] == TEXT + 16
               and v["bh"] == 2 and v["d"] == 16 and v["txt"] == TEXT
               and v["img"] == 16 for v in d.values())


def test_pack_latents_hand_built():
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).view(1, 2, 4, 4)
    got = flux.pack_latents(x)
    assert got.shape == (1, 4, 8)
    # token (row 0, col 1): channel c's 2x2 patch at rows 0-1, cols 2-3,
    # in (c, dy, dx) order
    assert got[0, 1].tolist() == [2, 3, 6, 7, 18, 19, 22, 23]
    assert torch.equal(got, ref_mod.pack(x))


def test_pack_mask_hand_built():
    """An 8x8-pixel fold: latent pixel (i, j)'s block as 64 channels (dy,
    dx), then packed 2x2 as a latent."""
    mask = torch.zeros(1, 1, 32, 32)
    mask[0, 0, 9, 20] = 1.0  # latent pixel (1, 2), dy 1, dx 4
    got = flux.pack_mask(mask)
    assert got.shape == (1, 4, 256)
    # token (0, 1) holds latent rows 0-1, cols 2-3; (1, 2) is dy2 1, dx2 0
    assert got.nonzero().tolist() == [[0, 1, (1 * 8 + 4) * 4 + 2]]
    cond = ref_mod.fill_condition(mask, torch.zeros(1, 16, 4, 4))
    assert torch.equal(cond[..., 64:], got)


def test_position_ids():
    ids = flux.position_ids(2, 2, 3, "cpu")
    assert ids.tolist() == [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 1],
                            [0, 0, 2], [0, 1, 0], [0, 1, 1], [0, 1, 2]]


def test_rope_against_pairwise_rotation():
    """Each adjacent pair (x_2j, x_2j+1) of a token rotated by its angle,
    written out; the angles per axis pos_a / 10000^(2j/d_a)."""
    axes = (4, 6, 6)
    ids = flux.position_ids(3, 2, 5, "cpu")
    table = flux.rope_table(ids, axes)
    y = torch.randn(1, ids.shape[0], 2, 16, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(3))
    got = flux.apply_rope(y, table)
    want = torch.empty_like(y)
    for t in range(ids.shape[0]):
        j = 0
        for a, d in enumerate(axes):
            for i in range(d // 2):
                ang = float(ids[t, a]) / 10_000.0 ** (2 * i / d)
                c, s = math.cos(ang), math.sin(ang)
                x0, x1 = y[0, t, :, 2 * j], y[0, t, :, 2 * j + 1]
                want[0, t, :, 2 * j] = x0 * c - x1 * s
                want[0, t, :, 2 * j + 1] = x0 * s + x1 * c
                j += 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    cos, sin = ref_mod.rope_tables(3, 2, 5, axes, "cpu")
    torch.testing.assert_close(ref_mod.rotate(y.transpose(1, 2), cos, sin),
                               want.transpose(1, 2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps,tokens", [(50, 4096), (28, 1024), (3, 64),
                                          (1, 256)])
def test_shifted_sigmas_formula(steps, tokens):
    sc = CONFIG["scheduler"]
    got = ode.shifted_sigmas(steps, tokens, **SHIFT)
    assert got.dtype == torch.float64 and got.shape == (steps + 1,)
    mu = 0.5 + (1.15 - 0.5) / (4096 - 256) * (tokens - 256)
    s = np.linspace(1.0, 1.0 / steps, steps)
    want = np.append(np.exp(mu) / (np.exp(mu) + (1 / s - 1)), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    assert got[0] == 1.0 and got[-1] == 0.0
    assert bool((got[1:] < got[:-1]).all())
    # the reference's grid rounds to the same fp32 values
    assert np.array_equal(got.float().numpy(),
                          ref_mod.sigmas(steps, tokens, sc).astype("float32"))
    if tokens == 4096:
        assert mu == pytest.approx(1.15)


def _field(t, x):
    return torch.sin(3 * x) * (1 + t) - x


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
@pytest.mark.parametrize("graphed", [False, True])
def test_explicit_linspace_grid_bitwise_default(method, graphed):
    """A given grid equal to the default's linspace gives the default's
    chain bit for bit, eager and graphed (the CPU bodies)."""
    x0 = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    fn = ode.INTEGRATORS[method]

    def graphs():
        return GraphCache(_field) if graphed else None

    want, nfe = fn(_field, x0, num_steps=7, graphs=graphs())
    got, nfe2 = fn(_field, x0, graphs=graphs(),
                   grid=torch.linspace(0.0, 1.0, 8))
    assert torch.equal(got, want) and nfe == nfe2


def test_explicit_grid_steps_and_reuse():
    """The grid's own steps, t_k to t_k+1, high noise first; a graphed
    chain takes another grid of the same length without a recapture."""
    x0 = torch.randn(2, 4, generator=torch.Generator().manual_seed(2))
    grid = ode.shifted_sigmas(6, 1024, **SHIFT)
    got, nfe = ode.odeint_euler(_field, x0, grid=grid)
    want, ts = x0, grid.float()
    for k in range(6):
        want = want + (ts[k + 1] - ts[k]) * _field(ts[k], want)
    assert nfe == 6 and torch.equal(got, want)
    cache = GraphCache(_field)
    assert torch.equal(ode.odeint_euler(_field, x0, graphs=cache,
                                        grid=grid)[0], want)
    other = ode.shifted_sigmas(6, 4096, **SHIFT)
    again = ode.odeint_euler(_field, x0, graphs=cache, grid=other)[0]
    assert cache.captures == 1
    assert torch.equal(again, ode.odeint_euler(_field, x0, grid=other)[0])


def test_amortized_velocity_concatenates():
    cond = torch.randn(2, 3, 5)
    seen = []

    def v(t, x):
        seen.append(x)
        return x[..., :4]

    x = torch.randn(2, 3, 4)
    out = ode.amortized_velocity(v, cond)(torch.tensor(0.5), x)
    assert torch.equal(seen[0], torch.cat([x, cond], dim=-1))
    assert torch.equal(out, x)


def _chain_inputs(b=1):
    g = torch.Generator().manual_seed(9)
    x_T = torch.randn((b, 16, 8, 8), generator=g)
    mask = torch.zeros((b, 1, 64, 64))
    mask[:, :, 8:40, 16:56] = 1.0
    latent = torch.randn((b, 16, 8, 8), generator=g)
    ctx = torch.randn((b, TEXT, 32), generator=g)
    pooled = torch.randn((b, 16), generator=g)
    return x_T, mask, latent, ctx, pooled


def _port_sampler(port, b, graphs):
    cond = torch.zeros((b, 16, 320))
    ctx = torch.zeros((b, TEXT, 32))
    pooled = torch.zeros((b, 16))
    v = ode.amortized_velocity(port.velocity(30.0, ctx, pooled, HW), cond)
    grid = ode.shifted_sigmas(4, 16, **SHIFT)

    def sample(x_T, mask, latent, c, p):
        cond.copy_(torch.cat([flux.pack_latents(latent),
                              flux.pack_mask(mask)], dim=-1))
        ctx.copy_(c)
        pooled.copy_(p)
        return ode.odeint_euler(v, flux.pack_latents(x_T), graphs=graphs,
                                grid=grid)[0]
    return sample, cond


def test_graphed_cpu_chain_equals_eager(pair):
    """The Fill chain as the benchmark drives it (the condition, context
    and pooled vector read from buffers, the shifted grid an input): the
    graphed chain's CPU bodies against the eager loop, bitwise; a new
    request's inputs change the chain."""
    port, _ = pair
    inputs = _chain_inputs()
    eager, _ = _port_sampler(port, 1, None)
    graphed, cond = _port_sampler(port, 1, GraphCache(port))
    want = eager(*inputs)
    assert torch.equal(graphed(*inputs), want)
    other = list(inputs)
    other[1] = 1.0 - other[1]
    assert not torch.equal(graphed(*other), want)


def test_reference_chain_matches_port_chain(pair):
    """The reference's Euler chain (its own packing and grid) against the
    port's in fp32 on the same inputs."""
    port, ref = pair
    x_T, mask, latent, ctx, pooled = inputs = _chain_inputs()
    got = _port_sampler(port, 1, None)[0](*inputs)
    grid = ref_mod.sigmas(4, 16, CONFIG["scheduler"]).astype("float32")
    cond = ref_mod.fill_condition(mask, latent)
    want, first = ref_mod.euler_chain(ref, ref_mod.pack(x_T), cond, ctx,
                                      pooled, 30.0, grid, HW)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(first, ref_mod.velocity(
        ref, ref_mod.pack(x_T), float(grid[0]), cond, ctx, pooled, 30.0, HW))


def test_create_flux_refuses():
    with pytest.raises(NotImplementedError):
        flux.create_flux(device="meta", **dict(TINY, patch_size=2))
    with pytest.raises(NotImplementedError):
        flux.create_flux(device="meta", **dict(TINY, guidance_embeds=False))
    with pytest.raises(ValueError):
        flux.create_flux(device="meta", **dict(TINY, sample_size=64))
    with pytest.raises(ValueError):
        flux.create_flux(device="meta", **dict(TINY, axes_dims_rope=[4, 4,
                                                                     4]))
