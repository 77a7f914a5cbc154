"""Checkpoints over `torch.save`.

Counterpart of `tpu_diffusion/train/checkpoint.py`: `CheckpointManager`
with `save(step, assets)`, `latest_step()`, `load(initial_assets) ->
(assets, step)`, retention of the newest `maximum`, and restart from the
latest; `load_pretrained` and the shape-matched `load_matching_params` for
warm starts. Assets are nested dicts of tensors and plain numbers, one file
`ckpt_<step>.pt` per step. Under a process group every rank calls `save`:
a tensor sharded over "model" (`parallel/tp.py`) is gathered, so the file
holds the global state, and the first rank alone writes it. `load` returns
full tensors; `parallel/tp.py:local_like` lays each back out as a sharded
tensor. The port's two norm implementations name their
parameters alike, and its modules were named from the start, so the JAX
package's `remap_norm_impl` and `remap_by_order` have no counterpart.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Mapping, Optional

import torch
import torch.distributed as dist

from tpu_diffusion_torch.parallel.tp import full_tensor

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return full_tensor(tree).detach().cpu()
    return tree


class CheckpointManager:
    def __init__(self, directory: str, maximum: int = 3):
        self.directory = os.path.abspath(directory)
        self.maximum = maximum
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, assets: Any) -> bool:
        """Write `assets` for `step` (atomically) and drop all but the
        newest `maximum` checkpoints."""
        assets = _to_cpu(assets)
        if not dist.is_initialized() or dist.get_rank() == 0:
            tmp = _path(self.directory, step) + ".tmp"
            torch.save(assets, tmp)
            os.replace(tmp, _path(self.directory, step))
            for old in _steps(self.directory)[:-self.maximum]:
                os.unlink(_path(self.directory, old))
        if dist.is_initialized():
            dist.barrier()  # no rank reads before the file is there
        return True

    def close(self) -> None:
        """Nothing to wait for: `torch.save` is synchronous. Kept for code
        written against the JAX manager, whose writes are asynchronous."""

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def load(self, initial_assets: Any):
        """The newest checkpoint (its tensors on the CPU), or
        `initial_assets` and step 0 when there is none."""
        step = self.latest_step()
        if step is None:
            return initial_assets, 0
        return torch.load(_path(self.directory, step), map_location="cpu",
                          weights_only=True), step


def load_pretrained(path: str) -> Optional[Any]:
    """The newest checkpoint under `path` as saved, for warm starts; None
    when there is none."""
    steps = _steps(os.path.abspath(path))
    if not steps:
        return None
    return torch.load(_path(os.path.abspath(path), steps[-1]),
                      map_location="cpu", weights_only=True)


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_matching_params(params: Mapping, loaded: Mapping,
                         verbose: bool = False):
    """Shape-matched partial load: every tensor of `loaded` whose name is in
    `params` with the same shape replaces it; the rest keeps `params`'
    values. Returns (merged flat dict, n_copied, n_skipped)."""
    merged = _flatten(params)
    copied = skipped = 0
    for key, val in _flatten(loaded).items():
        if key in merged and tuple(merged[key].shape) == tuple(val.shape):
            merged[key] = val
            copied += 1
        else:
            skipped += 1
            if verbose:
                print(f"[load_matching_params] skip {key}")
    return merged, copied, skipped
