"""The ResBlock kernel's route choice and tile geometry, on the CPU.

`kernels/resblock.py:resblock_route` names the conv kernel that a call
runs on the card and its tile geometry, which sets the scratch shapes the
wrapper allocates (`buffers`) and the C entry point is given; the CUDA
kernels themselves run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import pytest
import torch

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch.kernels import resblock

# the engine's five CIFAR ResBlocks ([64, 32, 32, Cin] -> 128, bf16),
# chip_smoke.py's bf16 extra cases (additive mode; identity skip at 16x16;
# the 64px UNet's first ResBlock) and two rows per tile at W = 64
WGMMA_SHAPES = [(64, 32, 32, 128, 128), (64, 32, 32, 256, 128),
                (64, 32, 32, 384, 128), (8, 32, 32, 256, 128),
                (8, 16, 16, 256, 256), (32, 64, 64, 128, 128),
                (1, 64, 64, 64, 256)]
# bf16 shapes the wrapper takes that the wgmma tiling does not divide:
# Cout not a multiple of 128, W = 128 (not in WGMMA_WIDTHS), a 4 x 32 image
# (H not a multiple of 256 / W)
MMA_SHAPES = [(2, 16, 16, 96, 192), (2, 16, 16, 96, 64),
              (1, 128, 128, 64, 128), (1, 2, 128, 128, 128),
              (2, 4, 32, 128, 128)]
ALL_SHAPES = WGMMA_SHAPES + MMA_SHAPES


def _covers(b, h, w, cin, cout, route, geometry):
    pixels, channels = geometry
    assert pixels % w == 0 and h % (pixels // w) == 0  # whole rows
    assert cout % channels == 0
    if route == "wgmma":
        assert (pixels, channels) == (256, 128)
        assert w in resblock.WGMMA_WIDTHS and cin % 32 == 0
    else:
        assert pixels == resblock.TILE_PIXELS
        assert channels == (64 if cout % 128 else 128)


@pytest.mark.parametrize("b,h,w,cin,cout", WGMMA_SHAPES)
def test_wgmma_route_at_the_engine_shapes(b, h, w, cin, cout):
    route, geometry = resblock.resblock_route(b, h, w, cin, cout,
                                              torch.bfloat16)
    assert route == "wgmma"
    _covers(b, h, w, cin, cout, route, geometry)


@pytest.mark.parametrize("b,h,w,cin,cout", MMA_SHAPES)
def test_mma_route_where_the_wgmma_tiling_does_not_divide(b, h, w, cin,
                                                          cout):
    route, geometry = resblock.resblock_route(b, h, w, cin, cout,
                                              torch.bfloat16)
    assert route == "mma"
    _covers(b, h, w, cin, cout, route, geometry)


@pytest.mark.parametrize("b,h,w,cin,cout", ALL_SHAPES)
def test_scalar_route_for_fp32(b, h, w, cin, cout):
    route, geometry = resblock.resblock_route(b, h, w, cin, cout,
                                              torch.float32)
    assert route == "scalar"
    _covers(b, h, w, cin, cout, route, geometry)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,cin,cout", ALL_SHAPES)
def test_buffers_follow_the_geometry(b, h, w, cin, cout, dtype):
    g1, g2 = resblock._num_groups(cin), resblock._num_groups(cout)
    route, geometry, mid, out, p1, p2, act = resblock.buffers(
        b, h, w, cin, cout, g1, g2, dtype, torch.device("cpu"))
    assert (route, geometry) == resblock.resblock_route(b, h, w, cin, cout,
                                                        dtype)
    assert mid.shape == out.shape == (b, h, w, cout)
    assert mid.dtype == out.dtype == dtype
    # GN1: one partial sum per GN_CHUNK pixels of each image, covering it
    assert p1.shape == (b, -(-h * w // resblock.GN_CHUNK), g1, 2)
    # GN2: one per conv block of each image, as the entry point indexes them
    tiles = h * w // geometry.tile_pixels
    assert tiles * geometry.tile_pixels == h * w
    assert p2.shape == (b, tiles, cout // geometry.channel_tile, g2, 2)
    assert p1.dtype == p2.dtype == torch.float32
    if route == "wgmma":
        assert act.shape == (b, h, w, max(cin, cout)) and act.dtype == dtype
    else:
        assert act is None


def test_no_shape_the_wrapper_takes_is_left_without_a_route():
    """Every bf16 shape the wrapper's check admits gets a route whose
    conditions hold (the entry point refuses a route that does not fit)."""
    for w in (1, 2, 4, 8, 16, 32, 64, 128):
        for h in (128 // w, 256 // w, 512 // w):
            for cin in (32, 64, 96, 128, 256, 384):
                for cout in (64, 128, 192, 256):
                    route, geometry = resblock.resblock_route(
                        2, h, w, cin, cout, torch.bfloat16)
                    _covers(2, h, w, cin, cout, route, geometry)
