"""The latent-diffusion UNet of Stable Diffusion 2 inpainting
(`tpu_diffusion_torch/models/ldm_unet.py`) on the CPU, at tiny widths,
against the benchmark's plain reference (`benchmark/reference/ldm_unet.py`)
on the same seeded weights; the cross-attention and LayerNorm entries'
plain paths; classifier-free guidance; the scaled-linear schedule; DDIM
with and without its x0 clipping; and the graphed CPU chain against the
eager one."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import ldm_unet as ref_mod
from tests.torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.core.schedules import (DDPM, quadratic_betas,
                                                scaled_linear_betas)
from tpu_diffusion_torch.kernels.attention import flash_cross_attention
from tpu_diffusion_torch.kernels.groupnorm import gn_route
from tpu_diffusion_torch.kernels.layernorm import layer_norm
from tpu_diffusion_torch.models import ldm_unet
from tpu_diffusion_torch.sampling import ancestral
from tpu_diffusion_torch.sampling.graph import GraphCache

TINY = dict(in_channels=9, out_channels=4, sample_size=8,
            block_out_channels=[32, 64], layers_per_block=1,
            down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
            attention_head_dim=[2, 4], cross_attention_dim=16,
            use_linear_projection=True, norm_num_groups=32, norm_eps=1e-5,
            flip_sin_to_cos=True, freq_shift=0)
PUBLISHED = dict(TINY, sample_size=64,
                 block_out_channels=[320, 640, 1280, 1280],
                 layers_per_block=2,
                 down_block_types=["CrossAttnDownBlock2D"] * 3
                 + ["DownBlock2D"],
                 up_block_types=["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
                 attention_head_dim=[5, 10, 20, 20], cross_attention_dim=1024)
SEED = 2 ** 33 + 21
TOKENS = 5


@pytest.fixture(scope="module")
def pair():
    """(the port's fp32 LDMUNet, the reference), one seed's weights."""
    weights = ref_mod.make_weights(TINY, SEED, "cpu")
    port = ldm_unet.create_ldm_unet(dtype=torch.float32, device="cpu",
                                    **TINY)
    port.load_state_dict(weights)
    ref = ref_mod.LDMUNet(TINY)
    ref.load_state_dict(weights)
    return port.eval().requires_grad_(False), ref.requires_grad_(False)


def _inputs(b=2, gen_seed=0):
    g = torch.Generator().manual_seed(gen_seed)
    x = torch.randn((b, 8, 8, 9), generator=g)
    t = torch.tensor([981, 20][:b])
    ctx = torch.randn((b, TOKENS, 16), generator=g)
    return x, t, ctx


def test_parameter_names_and_count():
    port = ldm_unet.create_ldm_unet(dtype=torch.float32, device="meta",
                                    **PUBLISHED)
    with torch.device("meta"):
        ref = ref_mod.LDMUNet(PUBLISHED)
    names = [n for n, _ in port.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    assert sum(p.numel() for p in port.parameters()) == 865_925_124
    assert ("down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k."
            "weight") in names
    assert "down_blocks.0.resnets.0.time_emb_proj.weight" in names
    assert "up_blocks.0.resnets.0.conv_shortcut.weight" in names


def test_full_forward_matches_reference(pair):
    port, ref = pair
    x, t, ctx = _inputs()
    with torch.no_grad():
        got, want = port(x, t, ctx), ref(x, t, ctx)
    assert got.shape == (2, 8, 8, 4)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    assert set(port.attn_decisions) == set(port.xattn_decisions) == {
        "down_blocks.0.attentions.0", "mid_block.attentions.0",
        "up_blocks.1.attentions.0", "up_blocks.1.attentions.1"}
    d = port.xattn_decisions["down_blocks.0.attentions.0"]
    assert (d["route"], d["bh"], d["tq"], d["tk"], d["d"]) == (
        "plain", 4, 64, TOKENS, 16)


@pytest.mark.parametrize("block", ["resblock", "resblock_skip", "down",
                                   "transformer"])
def test_block_matches_reference(pair, block):
    port, ref = pair
    g = torch.Generator().manual_seed(7)
    emb = torch.randn((2, 128), generator=g)
    ctx = torch.randn((2, TOKENS, 16), generator=g)
    if block == "resblock":
        p, r, cin = port.down_blocks[0].resnets[0], \
            ref.down_blocks[0].resnets[0], 32
    elif block == "resblock_skip":
        p, r, cin = port.down_blocks[1].resnets[0], \
            ref.down_blocks[1].resnets[0], 32
    elif block == "down":
        p, r, cin = port.down_blocks[0].downsamplers[0], \
            ref.down_blocks[0].downsamplers[0], 32
    else:
        p, r, cin = port.down_blocks[0].attentions[0], \
            ref.down_blocks[0].attentions[0], 32
    x = torch.randn((2, cin, 8, 8), generator=g).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        if block.startswith("resblock"):
            got, want = p(x, emb), r(x, emb)
        elif block == "down":
            got, want = p(x), r(x)
            assert got.shape == (2, 32, 4, 4)
        else:
            got, want = p(x, ctx), r(x, ctx)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_symmetric_downsample_differs_from_same_padding(pair):
    """The SD2 downsample pads every side; flax "SAME" (the JAX package's
    `Downsample`) pads the bottom and right only: a different function."""
    from tpu_diffusion_torch.models.unet import SameConv2d
    port, _ = pair
    conv = port.down_blocks[0].downsamplers[0].conv
    same = SameConv2d(32, 32, 3, stride=2, dtype=torch.float32)
    same.load_state_dict(conv.state_dict())
    x = torch.randn(1, 32, 8, 8)
    with torch.no_grad():
        assert not torch.allclose(conv(x), same(x))


@pytest.mark.parametrize("tq,tk", [(64, 5), (7, 77), (1, 1)])
def test_cross_attention_cpu_path(tq, tk):
    g = torch.Generator().manual_seed(tq)
    q, k, v = (torch.randn((3, n, 16), generator=g) for n in (tq, tk, tk))
    p = torch.softmax(q @ k.transpose(1, 2) / 4.0, dim=-1)
    torch.testing.assert_close(flash_cross_attention(q, k, v), p @ v,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_cpu_route(dtype):
    """The LayerNorm wrapper on the CPU is the plain fp32 expression, bit
    for bit, and `LayerNorm32` goes through it."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(7)
    x = (3 * torch.randn((2, 10, 40), generator=g) + 1).to(dtype)
    w = 1 + 0.1 * torch.randn(40, generator=g)
    b = 0.1 * torch.randn(40, generator=g)
    want = F.layer_norm(x.float(), (40,), w, b, 1e-5).to(dtype)
    got = layer_norm(x, w, b, 1e-5)
    assert got.dtype == dtype and torch.equal(got, want)
    norm = ldm_unet.LayerNorm32(40, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        assert torch.equal(norm(x), want)


def test_classifier_free_guidance_one_call():
    calls = []
    g = torch.Generator().manual_seed(3)
    eps2 = torch.randn((4, 8, 8, 4), generator=g)

    def eps_fn(x2, i2):
        calls.append((x2.clone(), i2.clone()))
        return eps2.to(torch.bfloat16)

    x = torch.randn((2, 8, 8, 4), generator=g)
    i = torch.tensor([5, 5])
    got = ancestral.classifier_free_eps_fn(eps_fn, 7.5)(x, i)
    assert len(calls) == 1
    assert torch.equal(calls[0][0], torch.cat([x, x]))
    assert torch.equal(calls[0][1], torch.cat([i, i]))
    e = eps2.to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    assert torch.equal(got, e[2:] + 7.5 * (e[:2] - e[2:]))


def test_scaled_linear_betas():
    got = scaled_linear_betas(1000, 0.00085, 0.012)
    want = np.linspace(math.sqrt(0.00085), math.sqrt(0.012), 1000) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] == pytest.approx(0.00085) and got[-1] == pytest.approx(
        0.012)
    np.testing.assert_array_equal(got, quadratic_betas(1000, 0.00085, 0.012))
    abar = np.cumprod(1 - got)
    np.testing.assert_allclose(
        abar, ref_mod.scaled_linear_abar(1000, 0.00085, 0.012), rtol=1e-12)


def _eps_fn():
    g = torch.Generator().manual_seed(11)
    w = torch.randn(4, 4, generator=g)

    def eps(x, i):
        return 3.0 * torch.tanh(x @ w) + i.float()[:, None, None, None] / 500
    return eps


def _old_ddim(eps_fn, ddpm, steps, x):
    """DDIM as the sampler computed it before the clip argument: x0
    clamped at every step and at the end."""
    rows = ancestral._ddim_per_step(ddpm, steps, 0.0)
    for row in rows:
        _, cx0, cdir, sab, _, sr, srm1 = (float(v) for v in row)
        eps = eps_fn(x, torch.full((x.shape[0],), int(row[0]),
                                   dtype=torch.int32))
        x0 = torch.clamp(sr * x - srm1 * eps, -1.0, 1.0)
        x = cx0 * x0 + cdir * (x - sab * x0)
    return torch.clamp(x, -1.0, 1.0)


@pytest.mark.parametrize("graphed", [False, True])
def test_ddim_clip_default_and_off(graphed):
    ddpm = DDPM.create(1000, scaled_linear_betas(1000))
    eps = _eps_fn()
    x = torch.randn((2, 4, 4, 4), generator=torch.Generator().manual_seed(1))
    graphs = GraphCache() if graphed else None
    default = ancestral.make_ddim_sampler(eps, ddpm, num_steps=10,
                                          graphs=graphs)(x)
    assert torch.equal(default, _old_ddim(eps, ddpm, 10, x))
    free = ancestral.make_ddim_sampler(eps, ddpm, num_steps=10,
                                       graphs=graphs, clip=False)(x)
    assert free.abs().max() > 1.0  # nothing clamps the latent
    # unclipped: x0 and x' by the same rows, no clamp anywhere
    rows = ancestral._ddim_per_step(ddpm, 10, 0.0)
    y = x
    for row in rows:
        _, cx0, cdir, sab, _, sr, srm1 = (float(v) for v in row)
        e = eps(y, torch.full((2,), int(row[0]), dtype=torch.int32))
        x0 = sr * y - srm1 * e
        y = cx0 * x0 + cdir * (y - sab * x0)
    assert torch.equal(free, y)


def test_graphed_cpu_chain_equals_eager(pair):
    """The SD2 chain as the benchmark drives it (guidance, the condition
    and the contexts read from buffers, no clipping): the graphed chain's
    CPU bodies against the eager loop, bitwise."""
    port, _ = pair
    g = torch.Generator().manual_seed(5)
    ctx2 = torch.randn((4, TOKENS, 16), generator=g)
    cond2 = torch.randn((4, 8, 8, 5), generator=g)

    def unet(x, i):
        return port(x, i, ctx2)

    eps_fn = ancestral.classifier_free_eps_fn(
        ancestral.amortized_eps_fn(unet, cond2), 7.5)
    ddpm = DDPM.create(1000, scaled_linear_betas(1000))
    x_T = torch.randn((2, 8, 8, 4), generator=g)
    eager = ancestral.make_ddim_sampler(eps_fn, ddpm, num_steps=4,
                                        clip=False)(x_T)
    graphs = GraphCache(port)
    graphed = ancestral.make_ddim_sampler(eps_fn, ddpm, num_steps=4,
                                          graphs=graphs, clip=False)
    assert torch.equal(graphed(x_T), eager)
    # the buffers are read by address: a new condition changes the chain
    cond2.mul_(-1)
    assert not torch.equal(graphed(x_T), eager)


def test_reference_chain_matches_port_chain(pair):
    """The reference's guided DDIM chain (two forwards, diffusers' form of
    the update) against the port's sampler in fp32."""
    port, ref = pair
    g = torch.Generator().manual_seed(9)
    ctx = torch.randn((2, TOKENS, 16), generator=g)
    ctx_u = torch.randn((1, TOKENS, 16), generator=g)
    cond = torch.randn((2, 8, 8, 5), generator=g)
    x_T = torch.randn((2, 8, 8, 4), generator=g)
    ctx2 = torch.cat([ctx, ctx_u.expand(2, -1, -1)])

    def unet(x, i):
        return port(x, i, ctx2)

    eps_fn = ancestral.classifier_free_eps_fn(
        ancestral.amortized_eps_fn(unet, torch.cat([cond, cond])), 7.5)
    ddpm = DDPM.create(1000, scaled_linear_betas(1000))
    got = ancestral.make_ddim_sampler(eps_fn, ddpm, num_steps=3,
                                      clip=False)(x_T)
    want, _ = ref_mod.ddim_cfg_chain(
        ref, x_T, cond, ctx, ctx_u,
        ref_mod.scaled_linear_abar(1000, 0.00085, 0.012), 3, 7.5)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("b,hw,c", [(8, 256, 2560), (8, 64, 2560),
                                    (8, 4096, 960), (8, 4096, 320)])
def test_groupnorm_routes_at_the_sd2_shapes(b, hw, c):
    """The widest norms (C = 2560 at 16x16 and 8x8, 80 channels a group)
    take the one-launch cluster route; the 64x64 ones the two-pass route."""
    route, geometry = gn_route(b, hw, c, 2)
    assert route == ("two_pass" if hw == 4096 else "cluster")
    if route == "cluster":
        cluster, rows = geometry
        assert c // 8 * rows <= 512 and (c // 8 * rows) % 32 == 0
