"""The frozen yardstick: FLOPs of the reference UNet and the kernels'
bounds at the shapes on the system's path."""

import json

import pytest

from benchmark.counts import bounds
from benchmark.counts.flops import forward_flops
from benchmark.harness import ROOT


def sizes(config):
    with open(ROOT / "benchmark" / "configs" / f"{config}.json") as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("config,mode,flops", [
    ("cifar10-unet", "full", 12_448_825_344),
    ("cifar10-unet", "encode", 3_243_114_496),
    ("cifar10-unet", "decode", 9_206_366_208),
    ("flowers64-unet", "full", 68_688_150_528),
])
def test_forward_flops_per_image(config, mode, flops):
    assert forward_flops(sizes(config), mode) == flops


@pytest.mark.parametrize("config,count", [("cifar10-unet", 38_307_203),
                                          ("flowers64-unet", 93_347_587)])
def test_reference_parameter_count(config, count):
    import torch

    from benchmark.reference.unet import UNet
    with torch.device("meta"):
        model = UNet(sizes(config))
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("fn,args,ms", [
    (bounds.resblock, (64, 32, 32, 128, 128), 0.0391),
    (bounds.resblock, (64, 32, 32, 256, 128), 0.0630),
    (bounds.resblock, (64, 32, 32, 384, 128), 0.0847),
    (bounds.gn_silu, (64, 32, 32, 128, True), 0.0100),
    (bounds.flash_fwd, (128, 1024, 64), 0.0347),
    (bounds.flash_bwd, (128, 1024, 64), 0.0869),
])
def test_kernel_bounds_at_the_path_shapes(fn, args, ms):
    assert fn(*args) * 1e3 == pytest.approx(ms, abs=5e-5)
