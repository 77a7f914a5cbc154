"""FLUX.1 Fill [dev]'s transformer on the card: one double-stream and one
single-stream block at the published widths in bf16 against the fp32
reference (`benchmark/reference/flux.py`) on the same weights, the flash
forward at the joint attention's [24, 4608, 128] against its plain
version, the graphed Euler chain on the shifted grid against its eager
chain, bitwise, at reduced depth, and at full depth the 57 flash launches
a replayed step.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flux.py
"""

import gc
import json
from pathlib import Path

import pytest
import torch

from tpu_diffusion_torch.kernels import attention

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "flux1-fill-dev.json")
                    .read_text())
TEXT, HW = 512, (64, 64)  # the cell's tokens: 512 text, 64 x 64 image


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _model(cuda, depth, seed=7):
    from benchmark.reference.flux import load_weights
    from tpu_diffusion_torch.models.flux import create_flux
    cfg = dict(CONFIG["model"], num_layers=depth[0],
               num_single_layers=depth[1])
    model = create_flux(dtype=torch.bfloat16, device=cuda, **cfg)
    load_weights(model, cfg, seed, cuda)
    return model.eval().requires_grad_(False), cfg


def _inputs(cuda, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    m = CONFIG["model"]
    x = torch.randn((1, HW[0] * HW[1], m["in_channels"]), generator=g,
                    device=cuda)
    ctx = torch.randn((1, TEXT, m["joint_attention_dim"]), generator=g,
                      device=cuda)
    pooled = torch.randn((1, m["pooled_projection_dim"]), generator=g,
                         device=cuda)
    return x, ctx, pooled


def _free():
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.0, 0.3])
def test_cuda_blocks_match_reference(cuda, sigma):
    """A double-stream and a single-stream block (with the embedders and
    the output layer) at the published widths and the cell's 4608 tokens:
    the bf16 system against the fp32 reference from the same bf16
    weights. bf16 rounds each GEMM's operands and the residual streams
    (2^-8): a mean relative gap of a few hundredths at most."""
    from benchmark.reference.flux import reference_flux
    model, cfg = _model(cuda, (1, 1))
    x, ctx, pooled = _inputs(cuda)
    with torch.no_grad():
        got = model(x, torch.tensor([sigma], device=cuda),
                    torch.tensor([30.0], device=cuda), ctx, pooled, HW)
    assert {d["route"] for d in model.attn_decisions.values()} == {"mma"}
    del model
    _free()
    ref = reference_flux(cfg, 7, cuda)
    want = ref(x, sigma, 30.0, ctx, pooled, HW)
    del ref
    _free()
    gap = float((got - want).abs().mean() / want.abs().mean())
    assert torch.isfinite(got).all() and gap < 0.03, gap


@pytest.mark.cuda
def test_cuda_flash_forward_at_the_joint_shape(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((24, TEXT + HW[0] * HW[1], 128), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    assert attention.flash_fwd_route(24, 4608, 128, torch.bfloat16) == "mma"
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v)
    want_o, want_lse = attention.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    tol = 1e-2 * want_o.float().abs().max().item()
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


def _chain(model, cuda, steps, graphs):
    from tpu_diffusion_torch.models.flux import pack_latents, pack_mask
    from tpu_diffusion_torch.sampling.ode import (amortized_velocity,
                                                  odeint_euler,
                                                  shifted_sigmas)
    g = torch.Generator(device=cuda).manual_seed(5)
    m = CONFIG["model"]
    x_T = torch.randn((1, 16, 128, 128), generator=g, device=cuda)
    mask = torch.zeros((1, 1, 1024, 1024), device=cuda)
    mask[..., 200:700, 300:900] = 1.0
    latent = torch.randn((1, 16, 128, 128), generator=g, device=cuda)
    cond = torch.cat([pack_latents(latent), pack_mask(mask)], dim=-1)
    ctx = torch.randn((1, TEXT, m["joint_attention_dim"]), generator=g,
                      device=cuda)
    pooled = torch.randn((1, m["pooled_projection_dim"]), generator=g,
                         device=cuda)
    v = amortized_velocity(model.velocity(30.0, ctx, pooled, HW), cond)
    sc = CONFIG["scheduler"]
    grid = shifted_sigmas(
        steps, HW[0] * HW[1], base_image_seq_len=sc["base_image_seq_len"],
        max_image_seq_len=sc["max_image_seq_len"],
        base_shift=sc["base_shift"], max_shift=sc["max_shift"]).to(
            cuda, torch.float32)
    return odeint_euler(v, pack_latents(x_T), graphs=graphs, grid=grid)[0]


@pytest.mark.cuda
def test_cuda_graphed_chain_equals_eager(cuda):
    """One double- and two single-stream blocks (one period of the 1:2
    pattern) at the published widths, 4 Euler steps on the shifted
    grid."""
    from tpu_diffusion_torch.sampling.graph import GraphCache
    model, _ = _model(cuda, (1, 2))
    want = _chain(model, cuda, 4, None)
    graphs = GraphCache(model)
    got = _chain(model, cuda, 4, graphs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)
    chain = next(iter(graphs.chains.values()))
    assert next(iter(chain.launches.values()))["flash_attention_fwd"] == 3
    assert next(iter(chain.replays.values())) == 4
    del model, graphs, chain
    _free()


@pytest.mark.cuda
def test_cuda_full_depth_replay_launches(cuda):
    """The whole model (19 + 38 blocks, 11.9B bf16 parameters): a replay
    of the captured step launches the flash forward 57 times, and two
    graphed steps equal the eager ones."""
    from tpu_diffusion_torch.models.flux import create_flux
    from tpu_diffusion_torch.sampling.graph import GraphCache
    model = create_flux(dtype=torch.bfloat16, device=cuda,
                        **CONFIG["model"]).eval().requires_grad_(False)
    want = _chain(model, cuda, 2, None)
    graphs = GraphCache(model)
    got = _chain(model, cuda, 2, graphs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, want)
    chain = next(iter(graphs.chains.values()))
    assert next(iter(chain.launches.values()))["flash_attention_fwd"] == 57
    kinds = [d["kind"] for d in model.attn_decisions.values()]
    assert kinds.count("double") == 19 and kinds.count("single") == 38
    del model, graphs, chain
    _free()
