"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX Pallas kernel run in interpret mode, on inputs made with numpy.
The hand-written CUDA kernels against their plain versions are in
`test_torch_cuda_kernels.py` (skipped without a card) and in
`chip_smoke.py`, at the UNet's shapes on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion.kernels.attention import \
    flash_attention_fused as jax_attention
from tpu_diffusion.kernels.groupnorm import \
    fused_groupnorm_silu as jax_groupnorm
from tpu_diffusion_torch.kernels import attention, groupnorm


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


# (T, C, heads, Pallas block_q) of tests/test_kernels.py, plus the UNet's
# mid-block token count T=16, and the shapes at which the card holds the
# tensor-core kernel against `dense_attention`: an uneven T at d=64, d=128,
# and T > 256 (its refilled key ring)
ATTN_CASES = [(128, 64, 2, 64), (96, 48, 3, 64), (256, 32, 2, 128),
              (16, 64, 2, 256), (100, 128, 2, 64), (64, 256, 2, 64),
              (320, 128, 2, 128)]


@pytest.mark.parametrize("t,c,heads,bq", ATTN_CASES)
def test_attention_matches_jax_kernel(interpret, t, c, heads, bq):
    qkv = np.random.default_rng(t).standard_normal(
        (2, t, 3 * c)).astype(np.float32)
    want = np.asarray(jax_attention(jnp.asarray(qkv), heads, bq))
    before = attention.launches
    got = attention.flash_attention_fused(torch.from_numpy(qkv), heads)
    ref = attention.dense_attention(torch.from_numpy(qkv), heads)
    # fp32 softmax on both sides; sums taken in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, ref)  # a CPU tensor takes the plain version
    assert attention.launches == before


def _gn_inputs(seed, b=2, hw=8, c=32, film=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, c)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    scale = shift = None
    if film:
        scale = (0.2 * rng.standard_normal((b, c))).astype(np.float32)
        shift = (0.2 * rng.standard_normal((b, c))).astype(np.float32)
    return x, gamma, beta, scale, shift


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("film,act,groups", [(False, "silu", 8),
                                             (False, "none", 8),
                                             (True, "silu", 4),
                                             (True, "none", 32)])
def test_groupnorm_matches_jax_kernel(interpret, film, act, groups):
    args = _gn_inputs(groups, film=film)
    want = np.asarray(jax_groupnorm(*map(_j, args), num_groups=groups,
                                    act=act))
    before = groupnorm.launches
    got = groupnorm.fused_groupnorm_silu(*map(_t, args), num_groups=groups,
                                         act=act)
    # fp32 statistics on both sides (E[x^2]-mean^2 there, two-pass here)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert groupnorm.launches == before


# the largest image on the CIFAR UNet's path (eight blocks of the cluster
# route) and the smallest (one block), without FiLM
@pytest.mark.parametrize("hw,c", [(32, 384), (4, 512)])
def test_groupnorm_matches_jax_kernel_at_path_images(interpret, hw, c):
    args = _gn_inputs(hw + c, hw=hw, c=c, film=False)
    want = np.asarray(jax_groupnorm(*map(_j, args), num_groups=32,
                                    act="none"))
    got = groupnorm.fused_groupnorm_silu(*map(_t, args), num_groups=32,
                                         act="none")
    # fp32 statistics on both sides, over 1024 x 12 and 16 x 16 entries
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# every (H = W, C) of the GroupNorm calls in one CIFAR UNet forward
# (`chip_smoke.py`'s GN_PATH_SHAPES), at batch 64
GN_PATH_IMAGES = [(4, 256), (4, 512), (8, 256), (8, 512), (16, 128),
                  (16, 256), (16, 384), (16, 512), (32, 128), (32, 256),
                  (32, 384)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hw,c", GN_PATH_IMAGES)
def test_gn_route(hw, c, itemsize):
    route, (cluster, rows) = groupnorm.gn_route(64, hw * hw, c, itemsize)
    assert route == "cluster"
    # the cluster's blocks cover the image exactly once, in whole pixels
    assert cluster in groupnorm.CLUSTER_SIZES
    assert (hw * hw) % cluster == 0
    threads = c // (16 // itemsize) * rows
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert rows * (c // (16 // itemsize)) >= 32  # one warp per group
    assert hw * hw // cluster * c * itemsize <= groupnorm.CHUNK_MAX
    assert (groupnorm.cluster_smem(c, hw * hw, itemsize, cluster, rows)
            <= groupnorm.SMEM_MAX)


@pytest.mark.parametrize("b,hw,c,itemsize", [(1, 128, 512, 4),
                                             (2, 64, 512, 4),
                                             (1, 64, 1024, 2)])
def test_gn_route_takes_two_passes_when_the_image_does_not_fit(b, hw, c,
                                                               itemsize):
    route, geometry = groupnorm.gn_route(b, hw * hw, c, itemsize)
    assert route == "two_pass"
    assert geometry == groupnorm.launch_geometry(c, hw * hw, itemsize)


def test_groupnorm_rejects_indivisible_groups():
    x, gamma, beta, _, _ = _gn_inputs(0, c=24, film=False)
    with pytest.raises(ValueError, match="not divisible"):
        groupnorm.fused_groupnorm_silu(_t(x), _t(gamma), _t(beta),
                                       num_groups=5)


def test_groupnorm_rejects_half_film():
    x, gamma, beta, scale, _ = _gn_inputs(0)
    with pytest.raises(ValueError, match="together"):
        groupnorm.fused_groupnorm_silu(_t(x), _t(gamma), _t(beta),
                                       _t(scale), None, num_groups=8)


@pytest.mark.parametrize("c,hw,itemsize", [(128, 1024, 2), (384, 256, 2),
                                           (512, 16, 2), (256, 64, 4),
                                           (2048, 4, 2)])
def test_groupnorm_launch_geometry_covers_image(c, hw, itemsize):
    rows, pix, nchunk = groupnorm.launch_geometry(c, hw, itemsize)
    threads = c // (16 // itemsize) * rows
    assert threads <= 1024
    assert pix == 4 * rows and nchunk * pix >= hw > (nchunk - 1) * pix
