"""The GroupNorm(+FiLM)+SiLU kernel's gradient, on the CPU.

The backward kernel (`csrc/groupnorm_silu.cu`) cannot run here; its
arithmetic can, as `reference_groupnorm_silu_backward`, which is held
against autograd through the plain forward. `_GroupNormAct` is run with
its two launches replaced by their plain versions, `FusedNormAct` (the
plain version on the CPU) against GroupNorm32 + FiLM + SiLU, and
`gn_bwd_route` at the 64px training step's shapes. The kernel itself is
held against the same plain version in `test_torch_cuda_kernels.py`.
"""

import functools

import pytest
import torch
import torch.nn.functional as F

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.cli import main as cli
from tpu_diffusion_torch.kernels import groupnorm
from tpu_diffusion_torch.models import nn as unet_nn
from tpu_diffusion_torch.utils import config as config_mod


def _inputs(seed, b, hw, c, film):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, hw, hw, c), generator=g, dtype=torch.float64) * 2
    gamma = 1 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    beta = 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    scale = shift = None
    if film:
        scale = 0.3 * torch.randn((b, c), generator=g, dtype=torch.float64)
        shift = 0.3 * torch.randn((b, c), generator=g, dtype=torch.float64)
    dy = torch.randn((b, hw, hw, c), generator=g, dtype=torch.float64)
    return tuple(None if t is None else t.float()
                 for t in (x, gamma, beta, scale, shift, dy))


def _autograd(x, gamma, beta, scale, shift, dy, groups, act):
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (x, gamma, beta, scale, shift)]
    y = groupnorm.reference_groupnorm_silu(*leaves, num_groups=groups,
                                           act=act)
    y.backward(dy)
    return [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("groups,c", [(32, 64), (8, 64), (32, 32)])
def test_backward_arithmetic_matches_autograd(film, act, groups, c):
    """The kernel's sums (S1 = sum dz, S2 = sum dz * xhat per image and
    channel) give autograd's gradients through the plain forward, the
    statistics taken from `group_stats` as the forward kernel writes them.
    fp32 on both sides; the gap is summation order (values of order 1-10
    over 32 pixels and up to 64 channels: 1e-4 absolute)."""
    x, gamma, beta, scale, shift, dy = _inputs(c + groups, 2, 4, c, film)
    want = _autograd(x, gamma, beta, scale, shift, dy, groups, act)
    stats = groupnorm.group_stats(x, groups)
    got = groupnorm.reference_groupnorm_silu_backward(
        dy, x, gamma, beta, scale, shift, stats, groups, act)
    assert stats.shape == (2, groups, 2) and stats.dtype == torch.float32
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"),
                          got, want):
        if w is None:
            assert g is None, name
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


def _plain_launch(calls, x, gamma, beta, scale, shift, num_groups, eps, act,
                  stats=None):
    calls.append(("forward", stats is not None))
    if stats is not None:
        stats.copy_(groupnorm.group_stats(x, num_groups, eps))
    return groupnorm.reference_groupnorm_silu(x, gamma, beta, scale, shift,
                                              num_groups, eps, act)


def _plain_backward(calls, dy, x, gamma, beta, scale, shift, stats,
                    num_groups, act):
    calls.append(("backward", dy.is_contiguous()))
    return groupnorm.reference_groupnorm_silu_backward(
        dy, x, gamma, beta, scale, shift, stats, num_groups, act)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("x_only", [False, True])
def test_autograd_function_routes_every_gradient(monkeypatch, film, act,
                                                 x_only):
    """`_GroupNormAct` with its launches replaced by the plain versions:
    the forward launch is asked for the statistics, the backward gets a
    contiguous dy, and the gradients reach x, gamma, beta and the FiLM
    embedding whose halves (strided views) are the scale and the shift;
    with `x_only` (a guidance gradient: the parameters need none) x
    alone."""
    calls = []
    monkeypatch.setattr(groupnorm, "_launch",
                        functools.partial(_plain_launch, calls))
    monkeypatch.setattr(groupnorm, "_launch_backward",
                        functools.partial(_plain_backward, calls))
    x, gamma, beta, scale, shift, dy = _inputs(3, 2, 4, 64, film)
    emb = torch.cat([scale, shift], 1) if film else None
    # the UNet hands the kernel a permuted (NHWC view of NCHW) gradient
    dy_nchw = dy.permute(0, 3, 1, 2).contiguous()

    def run(fn):
        leaves = [t.clone().requires_grad_(not x_only or k == 0)
                  if t is not None else None
                  for k, t in enumerate((x, gamma, beta, emb))]
        xl, gl, bl, el = leaves
        sc, sh = (el[:, :64], el[:, 64:]) if film else (None, None)
        y = fn(xl, gl, bl, sc, sh, 32, 1e-5, act)
        y.permute(0, 3, 1, 2).backward(dy_nchw)
        return [None if t is None else t.grad for t in leaves]

    got = run(groupnorm._GroupNormAct.apply)
    assert calls == [("forward", True), ("backward", True)]
    want = run(groupnorm.reference_groupnorm_silu)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_fused_norm_act_gradients_match_the_plain_chain(film, act):
    """`FusedNormAct` is differentiable on the CPU (the plain version), and
    its gradients are those of GroupNorm32 + FiLM + SiLU, the plain chain
    of `norm_impl="plain"`, in fp32: summation order only."""
    c = 64
    x, gamma, beta, scale, shift, dy = _inputs(5, 2, 4, c, film)
    fused = unet_nn.FusedNormAct(c, act=act, device="cpu")
    plain = unet_nn.GroupNorm32(c, device="cpu")
    for m in (fused, plain):
        with torch.no_grad():
            m.weight.copy_(gamma)
            m.bias.copy_(beta)
    x_nchw = unet_nn.channels_last(x.permute(0, 3, 1, 2))
    emb = torch.cat([scale, shift], 1) if film else None
    dy_nchw = dy.permute(0, 3, 1, 2)

    def run(fn, m):
        xl = x_nchw.clone().requires_grad_()
        el = emb.clone().requires_grad_() if film else None
        fn(m, xl, el).backward(dy_nchw)
        return [xl.grad, m.weight.grad, m.bias.grad,
                el.grad if film else None]

    def chain(m, xl, el):
        h = m(xl)
        if el is not None:
            h = h * (1 + el[:, :c, None, None]) + el[:, c:, None, None]
        return F.silu(h) if act == "silu" else h

    got = run(lambda m, xl, el: m(xl, film=el), fused)
    want = run(chain, plain)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_cli_build_keeps_the_plain_norms_on_the_cpu():
    """On the CPU (and the meta device) `cli.main.build` keeps the plain
    chain that the JAX parity tests hold against the JAX package."""
    cfg = config_mod.get_config("mnist,inpainting,amortized")
    for device in ("cpu", "meta"):
        model = cli.build(cfg, device=device)["model"]
        norms = [m for m in model.modules()
                 if isinstance(m, (unet_nn.GroupNorm32,
                                   unet_nn.FusedNormAct))]
        assert norms and all(isinstance(m, unet_nn.GroupNorm32)
                             for m in norms), device


def test_cli_build_takes_the_kernel_on_a_cuda_device(monkeypatch):
    """On a CUDA device `cli.main.build` asks for `norm_impl="fused"` (the
    device read as CUDA, the model built on the meta device here)."""
    seen = []
    real = cli.create_model

    def spy(**kw):
        seen.append(kw["norm_impl"])
        return real(**{**kw, "device": "meta"})

    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(cli, "create_model", spy)
    cfg = config_mod.get_config("flowers,inpainting,amortized")
    model = cli.build(cfg, device="meta")["model"]
    assert seen == ["fused"]
    norms = [m for m in model.modules()
             if isinstance(m, unet_nn.FusedNormAct)]
    assert len(norms) == 61
    assert not any(isinstance(m, unet_nn.GroupNorm32)
                   for m in model.modules())


# (H = W, C) of the 61 norms of the 64px training step (batch 32)
STEP_64PX = [(64, 128), (64, 256), (64, 384), (32, 128), (32, 256),
             (32, 384), (32, 512), (32, 640), (16, 256), (16, 384),
             (16, 640), (16, 768), (16, 896), (8, 384), (8, 512), (8, 896),
             (8, 1024)]


@pytest.mark.parametrize("hw,c", STEP_64PX)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_bwd_route_geometry(hw, c, itemsize):
    """The backward's route at the step's shapes: a cluster route's blocks
    fit the H100's shared memory, hold whole pixels and at most
    BWD_THREADS threads (or C / BWD_VEC); the two-pass chunks cover the
    image; images up to BWD_CLUSTER_MAX bytes take the cluster route."""
    route, geometry = groupnorm.gn_bwd_route(32, hw * hw, c, itemsize)
    cluster = groupnorm.bwd_cluster_route(32, hw * hw, c, itemsize)
    cv = c // groupnorm.BWD_VEC
    rows = max(1, groupnorm.BWD_THREADS // cv)
    threads = max(groupnorm.BWD_THREADS, cv)
    small = 2 * hw * hw * c * itemsize <= groupnorm.BWD_CLUSTER_MAX
    if cluster is not None:
        n, rows = cluster
        assert n in groupnorm.CLUSTER_SIZES and hw * hw % n == 0
        assert 1 <= cv * rows <= threads
        assert (groupnorm.bwd_cluster_smem(c, hw * hw, itemsize, n, rows)
                <= groupnorm.SMEM_MAX)
    else:
        # no cluster size fits: the image's x and dy exceed eight blocks
        assert all(groupnorm.bwd_cluster_smem(c, hw * hw, itemsize, n, rows)
                   > groupnorm.SMEM_MAX for n in groupnorm.CLUSTER_SIZES)
    if small and cluster is not None:
        assert (route, geometry) == ("cluster", cluster)
    else:
        rows, pix, nchunk = geometry
        assert route == "two_pass" and cv * rows <= threads
        assert pix * (nchunk - 1) < hw * hw <= pix * nchunk
        assert pix % rows == 0 and pix >= rows * groupnorm.BWD_PIXELS
        assert nchunk <= groupnorm.BWD_CHUNKS


def test_bwd_routes_of_the_64px_step():
    """bf16 at batch 32: the 8x8 images and the 16x16 one of 256 channels
    (x and dy 256 KB an image at most) take the cluster route, the rest
    the two-pass route; of those, all but the 64x64 images and the 32x32
    ones of 512 and 640 channels would fit the cluster route."""
    routes = {(hw, c): groupnorm.gn_bwd_route(32, hw * hw, c, 2)[0]
              for hw, c in STEP_64PX}
    assert {k for k, r in routes.items() if r == "cluster"} == {
        (8, 384), (8, 512), (8, 896), (8, 1024), (16, 256)}
    assert {k for k in routes
            if groupnorm.bwd_cluster_route(32, k[0] ** 2, k[1], 2) is None
            } == {(64, 128), (64, 256), (64, 384), (32, 512), (32, 640)}
