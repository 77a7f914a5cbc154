"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from tpu_diffusion_torch.kernels import attention, groupnorm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _gn_inputs(seed, b, hw, c, film, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, hw, hw, c), generator=g) * 2 + 0.5
    gamma = 1 + 0.1 * torch.randn(c, generator=g)
    beta = 0.1 * torch.randn(c, generator=g)
    scale = shift = None
    if film:
        scale = 0.2 * torch.randn((b, c), generator=g)
        shift = 0.2 * torch.randn((b, c), generator=g)
    return tuple(None if a is None else a.to(dev)
                 for a in (x, gamma, beta, scale, shift))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,c,heads", [
    (torch.float32, 256, 256, 4), (torch.bfloat16, 256, 256, 4),
    (torch.bfloat16, 16, 256, 4), (torch.float32, 100, 96, 3),
    (torch.bfloat16, 130, 256, 2)])
def test_cuda_attention_matches_plain(cuda, dtype, t, c, heads):
    g = torch.Generator().manual_seed(t)
    qkv = torch.randn((3, t, 3 * c), generator=g).to(cuda, dtype)
    before = attention.launches
    got = attention.flash_attention_fused(qkv, heads)
    want = attention.fused_attention_ref(qkv, heads)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    # fp32: summation order only; bf16: one output rounding (2^-8 relative)
    # plus the plain version's bf16 rounding of p
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,hw,film,act", [
    (torch.float32, 128, 32, True, "silu"), (torch.bfloat16, 384, 16, True,
                                             "silu"),
    (torch.bfloat16, 256, 16, False, "none"), (torch.bfloat16, 512, 4, False,
                                               "silu")])
def test_cuda_groupnorm_matches_plain(cuda, dtype, c, hw, film, act):
    x, gamma, beta, scale, shift = _gn_inputs(c, 3, hw, c, film, cuda)
    x = x.to(dtype)
    if film:
        scale, shift = scale.to(dtype), shift.to(dtype)
    before = groupnorm.launches
    got = groupnorm.fused_groupnorm_silu(x, gamma, beta, scale, shift, 32,
                                         act=act)
    want = groupnorm.reference_groupnorm_silu(x, gamma, beta, scale, shift,
                                              32, act=act)
    torch.cuda.synchronize()
    assert groupnorm.launches == before + 1
    # fp32 statistics on both sides; bf16: one output rounding
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    qkv = torch.zeros((2, 16, 3 * 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_fused(qkv, 2)  # d = 48
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attention.flash_attention_fused(qkv.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_fused(qkv.transpose(0, 1), 3)
    x, gamma, beta, _, _ = _gn_inputs(0, 2, 4, 64, False, cuda)
    with pytest.raises(ValueError, match="fp32"):
        groupnorm.fused_groupnorm_silu(x, gamma.half(), beta, num_groups=8)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.fused_groupnorm_silu(x.transpose(1, 2), gamma, beta,
                                       num_groups=8)
