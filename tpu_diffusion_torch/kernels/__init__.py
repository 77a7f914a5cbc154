"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Launch accounting: each wrapper counts its launches in a module global
when it is called (`attention.launches`, ...), which for a captured CUDA
graph is at its warm-ups and capture, not at its replays.
`launch_counts()` reads them all, by kernel. The graph layers add to
`OVERHEAD` what was counted outside the program's own work (a sampler
chain's warm-ups and captures, `sampling/graph.py:Chain`; a training
step's captures, `train/graph.py:StepGraphs`, whose warm-ups are the
run's own steps) and to `REPLAYED` each replay's launches
(`utils/graphs.py:replay`), so `executed_launches()` is the program's
launches on the card. A new kernel registers its counter in
`launch_counts`.
"""

from typing import Dict

# over every graph of the process
OVERHEAD: Dict[str, int] = {}
REPLAYED: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    from tpu_diffusion_torch.kernels import (adam, attention, groupnorm,
                                             layernorm, resblock)
    return {"flash_attention_fused": attention.launches,
            "flash_attention_fwd": attention.flash_fwd_launches,
            "flash_attention_bwd": attention.flash_bwd_launches,
            "flash_cross_attention": attention.flash_xattn_launches,
            "fused_groupnorm_silu": groupnorm.launches,
            "fused_groupnorm_silu_bwd": groupnorm.backward_launches,
            "fused_resblock": resblock.launches,
            "fused_adam_ema": adam.launches,
            "layer_norm": layernorm.launches}


def add(total: Dict[str, int], counts: Dict[str, int], times: int = 1):
    """Add `times` x `counts` into `total`, by kernel."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n * times


def executed_launches() -> Dict[str, int]:
    """Kernel launches that ran on the card outside warm-ups and captures:
    the wrappers' counts less `OVERHEAD`, plus `REPLAYED`."""
    return {name: n - OVERHEAD.get(name, 0) + REPLAYED.get(name, 0)
            for name, n in launch_counts().items()}


def refuse_grad(name: str, *tensors,
                hint: str = "or differentiate its plain version") -> None:
    """Raise where autograd would need the gradient of a launch that has
    none. The JAX package's counterpart raises too: `jax.grad` through a
    Pallas call without a custom VJP fails. The kernel writes its output
    through a raw pointer, so it would otherwise come back detached and
    the gradient would be silently lost."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad(), {hint}")
