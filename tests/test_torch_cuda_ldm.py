"""The latent-diffusion UNet's kernels and graphed chain on the card: the
cross-attention kernel (`flash_cross_attention`) against its plain version
at the 16 calls of a Stable Diffusion 2 step at 8 rows (77 keys), the
GroupNorm kernel at the SD2 UNet's (C, H*W, eps, act) shapes against
`reference_groupnorm_silu`, the LayerNorm kernel (`layer_norm`) at the
step's four [rows, C] shapes and off them against `layer_norm_ref`, and
the graphed guided DDIM chain against its eager chain, bitwise, with 16
cross-attention and 48 LayerNorm launches a replayed step.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ldm.py
"""

import json
from pathlib import Path

import pytest
import torch

from tpu_diffusion_torch.kernels import attention, groupnorm, layernorm

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "sd2-inpaint-unet.json"
# (bh, tq) of a step's cross-attention calls at 8 rows, and their count
XATTN_STEP = {(40, 4096): 5, (80, 1024): 5, (160, 256): 5, (160, 64): 1}
# [rows, C] of a step's LayerNorm calls at 8 rows (3 a transformer block)
LN_STEP = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk", [(bh, tq, 77) for bh, tq in XATTN_STEP]
                         + [(8, 100, 1), (4, 1000, 128), (2, 1, 33)])
def test_cuda_cross_attention_matches_plain(cuda, bh, tq, tk):
    g = torch.Generator(device=cuda).manual_seed(tq + tk)
    q = torch.randn((bh, tq, 64), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((bh, tk, 64), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attention.flash_xattn_launches
    got = attention.flash_cross_attention(q, k, v)
    want = attention.flash_attention_fwd_ref(q, k, v)[0]
    torch.cuda.synchronize()
    assert attention.flash_xattn_launches == before + 1
    # both sides round p and o to bf16: at most one ulp of o apart
    tol = 1e-2 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(got, attention.flash_cross_attention(q, k, v))


@pytest.mark.cuda
def test_cuda_cross_attention_refuses(cuda):
    q = torch.randn((2, 16, 64), device=cuda).bfloat16()
    k = torch.randn((2, 129, 64), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        attention.flash_cross_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_cross_attention(q.requires_grad_(), k[:, :77],
                                        k[:, :77])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,dtype",
                         [(r, c, torch.bfloat16) for r, c in LN_STEP]
                         + [(2048, 1280, torch.float32),
                            (300, 32, torch.float32), (7, 64, torch.bfloat16),
                            (5, 32, torch.bfloat16),
                            (33, 2048, torch.bfloat16),
                            (9, 2048, torch.float32)])
def test_cuda_layer_norm_matches_plain(cuda, rows, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (3 * torch.randn((rows, c), generator=g, device=cuda) + 1).to(dtype)
    w = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    b = 0.1 * torch.randn(c, generator=g, device=cuda)
    before = layernorm.launches
    got = layernorm.layer_norm(x, w, b, 1e-5)
    want = layernorm.layer_norm_ref(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert layernorm.launches == before + 1 and got.dtype == dtype
    # bf16: both sides round one fp32 value once, so one ulp apart at most;
    # fp32: the sums' order and rsqrt's last bits
    scale = want.float().abs().max().item()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(got, layernorm.layer_norm(x, w, b, 1e-5))


@pytest.mark.cuda
def test_cuda_layer_norm_refuses(cuda):
    w, b = torch.ones(320, device=cuda), torch.zeros(320, device=cuda)
    x = torch.randn((64, 320), device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="no backward"):
        layernorm.layer_norm(x, w.clone().requires_grad_(), b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm.layer_norm(x.t(), torch.ones(64, device=cuda),
                             torch.zeros(64, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm.layer_norm(x[:, :36].contiguous(), w[:36], b[:36], 1e-5)
    wide = torch.ones(2056, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm.layer_norm(torch.randn((4, 2056), device=cuda).bfloat16(),
                             wide, wide, 1e-5)


def _sd2(cuda):
    from benchmark.reference.ldm_unet import make_weights
    from tpu_diffusion_torch.models.ldm_unet import create_ldm_unet
    cfg = json.loads(CONFIG.read_text())
    model = create_ldm_unet(dtype=torch.bfloat16, device=cuda,
                            **cfg["model"])
    model.load_state_dict(make_weights(cfg["model"], 5, cuda))
    return model.eval().requires_grad_(False), cfg


@pytest.fixture(scope="module")
def sd2(cuda):
    return _sd2(cuda)


@pytest.mark.cuda
def test_cuda_groupnorm_at_the_sd2_shapes(cuda, sd2):
    from tpu_diffusion_torch.models.nn import FusedNormAct
    model, cfg = sd2
    shapes = set()

    def hook(module, args):
        x = args[0]
        shapes.add((x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                    module.eps, module.act, module.groups))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, FusedNormAct)]
    m = cfg["model"]
    with torch.no_grad():
        model(torch.randn((8, 64, 64, m["in_channels"]), device=cuda),
              torch.zeros(8, device=cuda),
              torch.randn((8, 77, m["cross_attention_dim"]), device=cuda))
    for h in handles:
        h.remove()
    assert {s[3] for s in shapes} >= {320, 960, 1920, 2560}
    assert {(s[4], s[5]) for s in shapes} == {(1e-5, "silu"),
                                              (1e-6, "none")}
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, h, w, c, eps, act, groups in sorted(shapes):
        x = (torch.randn((b, h, w, c), generator=g, device=cuda) * 2
             + 0.5).bfloat16()
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
        beta = 0.1 * torch.randn(c, generator=g, device=cuda)
        got = groupnorm.fused_groupnorm_silu(x, gamma, beta, None, None,
                                             groups, eps, act)
        want = groupnorm.reference_groupnorm_silu(x, gamma, beta, None, None,
                                                  groups, eps, act)
        tol = 2 ** -7 * max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0, msg=f"{b, h, w, c, eps, act}")


@pytest.mark.cuda
def test_cuda_sd2_graphed_chain_equals_eager(cuda, sd2):
    from tpu_diffusion_torch.core.schedules import DDPM, scaled_linear_betas
    from tpu_diffusion_torch.sampling.ancestral import (
        amortized_eps_fn, classifier_free_eps_fn, make_ddim_sampler)
    from tpu_diffusion_torch.sampling.graph import GraphCache
    model, cfg = sd2
    m = cfg["model"]
    g = torch.Generator(device=cuda).manual_seed(1)
    ctx2 = torch.randn((8, 77, m["cross_attention_dim"]), generator=g,
                       device=cuda)
    cond2 = torch.randn((8, 64, 64, 5), generator=g, device=cuda)
    x_T = torch.randn((4, 64, 64, 4), generator=g, device=cuda)

    def unet(x, i):
        return model(x, i, ctx2)

    eps_fn = classifier_free_eps_fn(amortized_eps_fn(unet, cond2), 7.5)
    ddpm = DDPM.create(1000, scaled_linear_betas(1000))
    want = make_ddim_sampler(eps_fn, ddpm, num_steps=10, clip=False)(x_T)
    graphs = GraphCache(model)
    graphed = make_ddim_sampler(eps_fn, ddpm, num_steps=10, graphs=graphs,
                                clip=False)
    got = graphed(x_T)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    launches = next(iter(next(iter(graphs.chains.values()))
                         .launches.values()))
    assert launches["flash_cross_attention"] == 16
    assert launches["flash_attention_fwd"] == 16
    assert launches["layer_norm"] == 48
    routes = {d["route"] for d in model.attn_decisions.values()}
    assert routes == {"wgmma", "mma"}
