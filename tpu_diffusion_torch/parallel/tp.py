"""Tensor-parallel parameter sharding over the mesh's "model" axis.

Counterpart of `tpu_diffusion/parallel/tp.py`. The layout rule is the JAX
package's `leaf_spec`, a pure function of a *flax* shape: shard the last
axis that the "model" size divides, for leaves of at least
`min_shard_elems`; small or indivisible leaves stay replicated. A torch
parameter is mapped to its flax shape through the converter's layouts
(`convert.py`: conv OIHW <- HWIO, Linear [out, in] <- Dense [in, out] or
the attention's 1-D conv (1, in, out), Embedding unchanged), the rule picks
a flax axis, and that axis is mapped back to the torch dim. So a conv whose
output channels the axis divides shards torch dim 0, the UNet's output conv
[3, 3, C, 3] shards its input channels (torch dim 1), and an Embedding
[num, dim] shards `dim` (torch dim 1).

Execution (gather at use): each rank stores only its slice of a sharded
parameter, and so of its EMA and Adam moments. A module's forward
all-gathers the full weight over "model" just before it runs; autograd
frees it after the backward. Activations are never channel-sharded, so
the math is the replicated step's: every "model" rank of one "data" rank
sees the same batch and computes the same full gradient, of which its slice
is its own (the gather's backward takes the slice; nothing is summed). A
sharded local tensor carries its layout (`SHARD_ATTR`), from which
`full_tensor` gathers it again, as a checkpoint save does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_diffusion_torch.parallel.mesh import MODEL_AXIS, Mesh

SHARD_ATTR = "_tp_shard"


def leaf_spec(shape, model_size: int, min_shard_elems: int = 1024
              ) -> Tuple:
    """The partition spec of one flax leaf, as a tuple (the JAX
    `PartitionSpec`'s entries): "model" on the last divisible axis of a
    >=2-D weight; () for a small or indivisible one (replicated)."""
    if len(shape) < 2 or int(np.prod(shape)) < min_shard_elems:
        return ()
    for axis in range(len(shape) - 1, -1, -1):
        if shape[axis] % model_size == 0 and shape[axis] >= model_size:
            spec = [None] * len(shape)
            spec[axis] = MODEL_AXIS
            return tuple(spec)
    return ()


def flax_layout(module: nn.Module, shape) -> Tuple[tuple, tuple]:
    """(flax shape, torch dim of each flax axis) of a parameter of `module`
    with torch shape `shape`. A 2-D Linear weight maps as a Dense [in, out]:
    the attention's 1-D conv kernels (1, in, out) add only a leading 1,
    which the rule never picks and which leaves the element count alone."""
    shape = tuple(shape)
    if len(shape) < 2:
        return shape, tuple(range(len(shape)))
    if isinstance(module, nn.Embedding):
        return shape, (0, 1)
    if len(shape) == 4 and isinstance(module, nn.Conv2d):  # OIHW <- HWIO
        o, i, h, w = shape
        return (h, w, i, o), (2, 3, 1, 0)
    if len(shape) == 2 and isinstance(module, nn.Linear):  # [out, in]
        return (shape[1], shape[0]), (1, 0)
    raise NotImplementedError(
        f"no flax layout for a {type(module).__name__} parameter of shape "
        f"{shape}")


def params_shardings(mesh: Mesh, model: nn.Module,
                     min_shard_elems: int = 1024
                     ) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim sharded over "model", or None for a
    replicated parameter}, by `leaf_spec` on each parameter's flax
    shape."""
    model_size = mesh.shape[MODEL_AXIS]
    out = {}
    for mod_name, module in model.named_modules():
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            dim = None
            if model_size > 1 and p.ndim >= 2:
                fshape, to_torch = flax_layout(module, p.shape)
                spec = leaf_spec(fshape, model_size, min_shard_elems)
                if spec:
                    dim = to_torch[spec.index(MODEL_AXIS)]
            out[name] = dim
    return out


def state_shardings(mesh: Mesh, state, min_shard_elems: int = 1024
                    ) -> Dict[str, Dict[str, Optional[int]]]:
    """Layouts of a `TrainState`: params, ema and the Adam moments
    (`opt_state`, by parameter name) all follow the parameters' layout,
    where the JAX package applies `leaf_spec` to each tree's shapes alike;
    the step and the counters stay replicated."""
    params = params_shardings(mesh, state.model, min_shard_elems)
    return {"params": params, "ema": dict(params), "opt_state": dict(params)}


class ShardInfo:
    """Where a local tensor sits in its full tensor: `dim`, this rank's
    `index` of `size` equal slices, and the "model" group that holds the
    others."""

    def __init__(self, group, dim: int, index: int, size: int):
        self.group, self.dim, self.index, self.size = group, dim, index, size

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `full`, contiguous."""
        return full.chunk(self.size, self.dim)[self.index].contiguous()


def _all_gather(x: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(info.size)]
    dist.all_gather(parts, x, group=info.group)
    return torch.cat(parts, info.dim)


class _GatherAtUse(torch.autograd.Function):
    """Forward: the full weight from the "model" ranks' slices. Backward:
    this rank's slice of the full gradient, which every "model" rank of a
    "data" rank computes alike."""

    @staticmethod
    def forward(ctx, local, info):
        ctx.info = info
        return _all_gather(local.detach(), info)

    @staticmethod
    def backward(ctx, grad):
        return ctx.info.local(grad), None


def _gather_params(module: nn.Module, args) -> None:
    # an instance attribute shadows `_parameters` in `module.weight`, and
    # `_CastParams.cast` reads it first
    for name, info in module._tp_shards.items():
        module.__dict__[name] = _GatherAtUse.apply(module._parameters[name],
                                                   info)


def _drop_gathered(module: nn.Module, args, output) -> None:
    for name in module._tp_shards:
        module.__dict__.pop(name, None)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The full tensor of a sharded local tensor (a collective over its
    "model" group: every rank of the group must call it), or `t` itself."""
    info = getattr(t, SHARD_ATTR, None)
    if info is None:
        return t
    with torch.no_grad():
        return _all_gather(t, info)


def local_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full` in the layout of `like`: its slice where `like` is sharded,
    else `full` itself."""
    info = getattr(like, SHARD_ATTR, None)
    return full if info is None else info.local(full)


def _shard_(t: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    t.data = info.local(t.data)
    setattr(t, SHARD_ATTR, info)
    return t


@torch.no_grad()
def shard_state_(mesh: Mesh, state, shardings=None,
                 min_shard_elems: int = 1024) -> int:
    """Lay a replicated `TrainState` out by `shardings` (default:
    `state_shardings`), in place: every sharded parameter, its EMA and its
    Adam moments keep only this rank's slice, and the parameter's module
    gathers the full weight at each forward. Returns the number of sharded
    parameters."""
    if shardings is None:
        shardings = state_shardings(mesh, state, min_shard_elems)
    group, index = mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS)
    size = mesh.shape[MODEL_AXIS]
    layout = shardings["params"]
    adam = state.optimizer.adam.state
    if any(hasattr(p, SHARD_ATTR) for p in state.model.parameters()):
        raise ValueError("the state is sharded already")
    n = 0
    for mod_name, module in state.model.named_modules():
        shards = {}
        for p_name, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            dim = layout[name]
            if dim is None:
                continue
            info = ShardInfo(group, dim, index, size)
            _shard_(p, info)
            if shardings["ema"].get(name) is not None:
                _shard_(state.ema.params[name], info)
            for key, v in adam.get(p, {}).items():
                if (shardings["opt_state"].get(name) is not None
                        and isinstance(v, torch.Tensor) and v.ndim):
                    _shard_(v, info)
            shards[p_name] = info
            n += 1
        if shards:
            module._tp_shards = shards
            module.register_forward_pre_hook(_gather_params)
            module.register_forward_hook(_drop_gathered)
    return n


def opt_state_tree(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The Adam moments by parameter name ({name: {"exp_avg", "exp_avg_sq"}},
    empty before the first update), each carrying its parameter's layout."""
    adam = state.optimizer.adam.state
    out = {}
    for name, p in state.model.named_parameters():
        moments = {k: v for k, v in adam.get(p, {}).items()
                   if k in ("exp_avg", "exp_avg_sq")}
        info = getattr(p, SHARD_ATTR, None)
        for v in moments.values():
            if info is not None:
                setattr(v, SHARD_ATTR, info)
        if moments:
            out[name] = moments
    return out


def stored_bytes(tensors) -> int:
    """Bytes this rank stores for `tensors` (local slices as they are)."""
    return sum(t.numel() * t.element_size() for t in tensors)
