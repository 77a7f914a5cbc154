"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA card and skip without one (the kernels have no CPU
mode). The file imports nothing of JAX, so on a machine with a card and
without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from tpu_diffusion_torch.kernels import attention, groupnorm, resblock


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
    (torch.bfloat16, 130, 256, 2),
    # the tensor-core kernel: an uneven T, the refilled ring (T > 256),
    # d = 32, d = 128 with its two slots refilled, one key
    (torch.bfloat16, 100, 256, 4), (torch.bfloat16, 1024, 256, 4),
    (torch.bfloat16, 256, 128, 4), (torch.bfloat16, 300, 256, 2),
    (torch.bfloat16, 1, 64, 1)])
def test_cuda_attention_matches_plain(cuda, dtype, t, c, heads):
    g = torch.Generator().manual_seed(t)
    qkv = torch.randn((3, t, 3 * c), generator=g).to(cuda, dtype)
    before = attention.launches
    got = attention.flash_attention_fused(qkv, heads)
    want = attention.dense_attention(qkv, heads)
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


def _flash_inputs(seed, bh, t, d, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((bh, t, d), generator=g).to(dev, dtype)
                 for _ in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bh,t,d", [
    (torch.bfloat16, 8, 1024, 64), (torch.float32, 4, 1024, 64),
    (torch.float32, 3, 1000, 64), (torch.bfloat16, 2, 100, 32),
    (torch.float32, 2, 130, 128), (torch.bfloat16, 2, 64, 128),
    (torch.bfloat16, 3, 1000, 64), (torch.bfloat16, 2, 520, 128)])
def test_cuda_flash_forward_matches_plain(cuda, dtype, bh, t, d):
    q, k, v, _ = _flash_inputs(t + d, bh, t, d, dtype, cuda)
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v)
    want_o, want_lse = attention.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:  # summation order only
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=2e-5)
    else:
        # both sides round o to bf16 after rounding p (2^-9 relative per
        # term, far below one ulp of o): at most one bf16 ulp apart, which
        # is at most 2^-7 of the largest entry
        tol = 1e-2 * want_o.float().abs().max().item()
        torch.testing.assert_close(o.float(), want_o.float(), atol=tol,
                                   rtol=0)
    # lse is fp32 on both sides: summation order only
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bh,t,d", [
    (torch.bfloat16, 8, 1024, 64), (torch.float32, 4, 1024, 64),
    (torch.float32, 3, 1000, 64), (torch.bfloat16, 2, 100, 32),
    (torch.float32, 2, 130, 128), (torch.bfloat16, 2, 130, 128),
    # the one-pass kernel: an uneven T over several key blocks, one tile,
    # d = 32 and d = 128 over several key blocks
    (torch.bfloat16, 4, 1000, 64), (torch.bfloat16, 3, 64, 64),
    (torch.bfloat16, 2, 1000, 32), (torch.bfloat16, 2, 520, 128)])
def test_cuda_flash_backward_matches_plain(cuda, dtype, bh, t, d):
    q, k, v, g = _flash_inputs(t * d, bh, t, d, dtype, cuda)
    o, lse = attention.flash_attention_fwd_ref(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    before = attention.flash_bwd_launches
    got = attention.flash_attention_bwd(q, k, v, g, lse, delta)
    want = attention.flash_attention_bwd_ref(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert attention.flash_bwd_launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype
        # relative to the gradient's scale: fp32 sums of T terms in another
        # order; bf16: the tensor-core kernels round p and ds to bf16 for
        # their products, and each side rounds its output once
        scale = b.float().abs().max().item()
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_backward_twice(cuda):
    """The bf16 backward sums dq with atomics, in an order that changes from
    run to run: two calls agree within the tolerance against the plain
    version, and dk and dv (no atomics) bitwise."""
    q, k, v, g = _flash_inputs(7, 8, 1024, 64, torch.bfloat16, cuda)
    o, lse = attention.flash_attention_fwd_ref(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    one = attention.flash_attention_bwd(q, k, v, g, lse, delta)
    two = attention.flash_attention_bwd(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    tol = 1e-2 * one[0].float().abs().max().item()
    torch.testing.assert_close(one[0].float(), two[0].float(), atol=tol,
                               rtol=0)
    assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])


@pytest.mark.cuda
def test_cuda_flash_autograd_uses_both_kernels(cuda):
    q, k, v, g = (x.requires_grad_(i < 3) for i, x in enumerate(
        _flash_inputs(0, 4, 1024, 64, torch.float32, cuda)))
    f0, b0 = attention.flash_fwd_launches, attention.flash_bwd_launches
    o = attention.flash_attention(q.view(2, 2, 1024, 64),
                                  k.view(2, 2, 1024, 64),
                                  v.view(2, 2, 1024, 64))
    grads = torch.autograd.grad((o * g.view_as(o)).sum(), (q, k, v))
    assert (attention.flash_fwd_launches, attention.flash_bwd_launches) == (
        f0 + 1, b0 + 1)
    ref = attention.flash_attention_fwd_ref(q, k, v)[0]
    want = torch.autograd.grad((ref * g).sum(), (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _resblock_inputs(seed, b, hw, cin, cout, film, skip, dtype, dev):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = (rand(b, hw, hw, cin) * 1.5 + 0.3).to(dtype)
    args = [x, 1 + rand(cin, scale=0.1), rand(cin, scale=0.1),
            rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(dtype),
            rand(cout, scale=0.1), 1 + rand(cout, scale=0.1),
            rand(cout, scale=0.1),
            (1 + rand(b, cout, scale=0.2)) if film else None,
            rand(b, cout, scale=0.2),
            rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5).to(dtype),
            rand(cout, scale=0.1)]
    if skip:
        args += [rand(cin, cout, scale=cin ** -0.5).to(dtype),
                 rand(cout, scale=0.1)]
    return [None if a is None else a.to(dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,hw,cin,cout,film,skip", [
    (torch.bfloat16, 3, 32, 128, 128, True, False),   # the CIFAR shapes
    (torch.bfloat16, 2, 32, 256, 128, True, True),
    (torch.bfloat16, 2, 32, 384, 128, True, True),
    (torch.float32, 2, 32, 128, 128, True, False),
    (torch.float32, 2, 16, 96, 64, False, True),      # additive, 32-chunks
    (torch.bfloat16, 2, 16, 96, 192, False, True),    # 64-channel tiles
    (torch.bfloat16, 1, 64, 64, 256, True, True),     # two rows per block
    (torch.float32, 3, 16, 64, 64, True, False)])     # 8 rows per block
def test_cuda_resblock_matches_plain(cuda, dtype, b, hw, cin, cout, film,
                                     skip):
    args = _resblock_inputs(cin + cout, b, hw, cin, cout, film, skip, dtype,
                            cuda)
    before = resblock.launches
    got = resblock.fused_resblock(*args)
    torch.backends.cudnn.allow_tf32 = False  # the plain convs in full fp32
    want = resblock.resblock_reference(*args)
    torch.cuda.synchronize()
    assert resblock.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hw, hw, cout)
    scale = want.float().abs().max().item()
    # fp32: the order of the sums, through two convolutions and two norms;
    # bf16: the mid tensor is rounded to bf16 before GN2 where the plain
    # version keeps it fp32 (2^-9 relative per element, averaged out by the
    # second convolution), and each side rounds its output once (one bf16
    # ulp, at most 2^-8 of the largest entry)
    tol = (2e-5 if dtype == torch.float32 else 1e-2) * scale
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_resblock_rejects_what_the_kernel_does_not_take(cuda):
    args = _resblock_inputs(0, 2, 16, 64, 64, True, False, torch.float32,
                            cuda)
    with pytest.raises(ValueError, match="unsupported shape"):
        bad = _resblock_inputs(0, 2, 12, 64, 64, True, False, torch.float32,
                               cuda)
        resblock.fused_resblock(*bad)  # 12 does not divide 128
    with pytest.raises(ValueError, match="unsupported shape"):
        bad = _resblock_inputs(0, 2, 16, 48, 64, True, True, torch.float32,
                               cuda)
        resblock.fused_resblock(*bad)  # Cin not a multiple of 32
    with pytest.raises(ValueError, match="bf16 or fp32"):
        resblock.fused_resblock(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        resblock.fused_resblock(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="w1 must be"):
        resblock.fused_resblock(*args[:3], args[3].bfloat16(), *args[4:])
    with pytest.raises(ValueError, match="identity skip"):
        bad = _resblock_inputs(0, 2, 16, 32, 64, True, False, torch.float32,
                               cuda)
        resblock.fused_resblock(*bad)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    qkv = torch.zeros((2, 16, 3 * 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_fused(qkv, 2)  # d = 48
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attention.flash_attention_fused(qkv.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_fused(qkv.transpose(0, 1), 3)
    q = torch.zeros((2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_fwd(q, q, q)
    q = torch.zeros((2, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        attention.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="match"):
        attention.flash_attention_fwd(q, q[:, :8], q)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_fwd(q, q.transpose(0, 1).contiguous()
                                      .transpose(0, 1), q)
    lse = torch.zeros((2, 16), device=cuda)
    with pytest.raises(ValueError, match="lse"):
        attention.flash_attention_bwd(q, q, q, q, lse.half(), lse)
    b16 = torch.zeros((2, 16, 3 * 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_attention_fused(b16, 2)  # d = 48
    with pytest.raises(ValueError, match="aligned"):
        attention.flash_attention_fused(b16.flatten()[4:4 + 16 * 192]
                                        .view(1, 16, 192), 1)
    qb = torch.zeros((2, 16, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="match"):
        attention.flash_attention_bwd(qb, qb, qb, qb.float(), lse, lse)
    with pytest.raises(ValueError, match="delta"):
        attention.flash_attention_bwd(qb, qb, qb, qb, lse, lse[:, :8])
    x, gamma, beta, _, _ = _gn_inputs(0, 2, 4, 64, False, cuda)
    with pytest.raises(ValueError, match="fp32"):
        groupnorm.fused_groupnorm_silu(x, gamma.half(), beta, num_groups=8)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.fused_groupnorm_silu(x.transpose(1, 2), gamma, beta,
                                       num_groups=8)
