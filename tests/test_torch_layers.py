"""The port's layers import downward only, and the kernels' launch
accounting (`tpu_diffusion_torch/kernels/__init__.py`).

The trainer and its graphs load nothing of the samplers or the CLIs; the
kernels, the models and the capture layer (`utils/graphs.py`) load
nothing of the trainer either. Each case imports its module in a fresh
interpreter."""

import subprocess
import sys
from pathlib import Path

import pytest

from torch_twin import one_torch_thread  # noqa: F401
from tpu_diffusion_torch import kernels

ROOT = Path(__file__).resolve().parents[1]
ABOVE_TRAINING = ("tpu_diffusion_torch.sampling", "tpu_diffusion_torch.cli")
ABOVE_MODELS = ABOVE_TRAINING + ("tpu_diffusion_torch.train",)
MODULES = {"train.trainer": ABOVE_TRAINING, "train.graph": ABOVE_TRAINING,
           "utils.graphs": ABOVE_MODELS,
           "kernels.attention": ABOVE_MODELS,
           "kernels.groupnorm": ABOVE_MODELS,
           "kernels.resblock": ABOVE_MODELS, "kernels.adam": ABOVE_MODELS,
           "kernels.layernorm": ABOVE_MODELS,
           "models.unet": ABOVE_MODELS, "models.ldm_unet": ABOVE_MODELS,
           "models.flux": ABOVE_MODELS}
KERNELS = ["flash_attention_fused", "flash_attention_fwd",
           "flash_attention_bwd", "flash_cross_attention",
           "fused_groupnorm_silu", "fused_groupnorm_silu_bwd",
           "fused_resblock", "fused_adam_ema", "layer_norm"]


@pytest.fixture(scope="module")
def imports():
    """Every case's fresh interpreter, started at once: each spends its
    seconds importing torch, so they overlap."""
    procs = {}
    for module, above in MODULES.items():
        code = (f"import sys, tpu_diffusion_torch.{module}\n"
                f"above = sorted(m for m in sys.modules if m.startswith("
                f"{above!r}))\n"
                "assert not above, above\n")
        procs[module] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("module", sorted(MODULES))
def test_module_loads_no_layer_above_it(imports, module):
    out, _ = imports[module].communicate(timeout=120)
    assert imports[module].returncode == 0, out


def test_launch_accounting(monkeypatch):
    """`launch_counts` reads the nine wrappers' counters by name, and
    `executed_launches` is the counts less `OVERHEAD` plus `REPLAYED`."""
    from tpu_diffusion_torch.kernels import (adam, attention, groupnorm,
                                             layernorm, resblock)
    counters = [(attention, "launches"), (attention, "flash_fwd_launches"),
                (attention, "flash_bwd_launches"),
                (attention, "flash_xattn_launches"), (groupnorm, "launches"),
                (groupnorm, "backward_launches"), (resblock, "launches"),
                (adam, "launches"), (layernorm, "launches")]
    for n, (module, name) in enumerate(counters):
        monkeypatch.setattr(module, name, 100 * (n + 1))
    counts = kernels.launch_counts()
    assert list(counts) == KERNELS
    assert list(counts.values()) == [100 * (n + 1) for n in range(9)]

    monkeypatch.setattr(kernels, "OVERHEAD", {})
    monkeypatch.setattr(kernels, "REPLAYED", {})
    kernels.add(kernels.OVERHEAD, {"fused_resblock": 3, "fused_adam_ema": 1})
    kernels.add(kernels.REPLAYED, {"fused_resblock": 5}, times=4)
    kernels.add(kernels.REPLAYED, {"flash_attention_bwd": 2})
    assert kernels.OVERHEAD == {"fused_resblock": 3, "fused_adam_ema": 1}
    assert kernels.REPLAYED == {"fused_resblock": 20,
                                "flash_attention_bwd": 2}
    assert kernels.executed_launches() == {
        name: counts[name] - kernels.OVERHEAD.get(name, 0)
        + kernels.REPLAYED.get(name, 0) for name in KERNELS}
    assert kernels.executed_launches()["fused_resblock"] == 700 - 3 + 20
    assert kernels.executed_launches()["fused_adam_ema"] == 800 - 1
