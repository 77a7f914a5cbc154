"""Debug / profiling / checkpoint-surgery utilities.

Counterpart of `tpu_diffusion/utils/debug.py`, each name mapped to its
PyTorch equivalent:
  * `enable_debug_nans` -> autograd anomaly mode with `check_nan`. It is
    weaker than `jax_debug_nans`, which traps a NaN made by any op: anomaly
    mode checks only what the backward produces;
  * `trace` -> `torch.profiler.record_function`, a named range in a
    profiler trace; `profile(logdir)` -> a `torch.profiler` trace of the
    block (CPU, and CUDA where the build has it) written to `logdir`;
  * `compiled_cost` -> the FLOPs of one call counted by
    `torch.utils.flop_counter.FlopCounterMode` (it gives no byte count,
    unlike XLA's cost analysis);
  * `checkify_sampler` -> a wrapper that raises when the result holds a
    NaN or inf (checkify's float checks test every intermediate value);
  * `strip_checkpoint_keys` -> a copy (the artifacts/newgvp_j/
    model_test.py:1-14 checkpoint-surgery helper).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterable

import torch


def enable_debug_nans(enable: bool = True):
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


@contextlib.contextmanager
def trace(name: str):
    """Profiler annotation: `with trace("train_step"): ...`."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a profiler trace of the block into `logdir/trace.json`
    (Chrome trace format)."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
            activities=torch.profiler.supported_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn: Callable, *example_args) -> Dict[str, float]:
    """{"flops": ...} of one call of `fn` on the example arguments
    (replaces the reference's count_flops_attn hooks, unet.py:404-421)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def checkify_sampler(sample_fn: Callable) -> Callable:
    """Wrap a sampler so that a NaN or inf in its result raises
    FloatingPointError (SURVEY.md §5.2)."""

    def wrapped(*args, **kwargs):
        out = sample_fn(*args, **kwargs)
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        for leaf in leaves:
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and not bool(torch.isfinite(leaf).all())):
                raise FloatingPointError(
                    f"{getattr(sample_fn, '__name__', 'sampler')} returned "
                    f"a non-finite value")
        return out

    return wrapped


def strip_checkpoint_keys(assets: Dict[str, Any],
                          prefixes: Iterable[str]) -> Dict[str, Any]:
    """Drop checkpoint entries matching any prefix: either the full
    slash-joined path starts with it ('params/schedule' removes exactly
    that subtree) or a key of that exact NAME appears at any depth (the
    reference's surgery strips buffers like 'schedule' wherever they
    live). Matching is path-component exact — 'schedule' does NOT match
    'schedule_v2'."""
    prefixes = tuple(prefixes)

    def matches(p: str, k: str) -> bool:
        return any(p == pre or p.startswith(pre + "/") or k == pre
                   for pre in prefixes)

    def prune(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                p = f"{path}/{k}" if path else k
                if matches(p, k):
                    continue
                out[k] = prune(v, p)
            return out
        return tree

    return prune(assets)
