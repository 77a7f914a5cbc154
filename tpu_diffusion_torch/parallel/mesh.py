"""The ("data", "model") mesh over the ranks of a `torch.distributed` world.

Counterpart of `tpu_diffusion/parallel/mesh.py`. A rank is one process on
one device (one GPU under NCCL, one CPU process under gloo), so the global
device set is the world's ranks, laid out row-major: rank r sits at
(r // model, r % model), and consecutive ranks share a "model" group.

  * the batch is sharded over "data": each rank keeps its slice
    (`shard_batch`) and the gradients are averaged over "data"
    (`train/trainer.py`);
  * parameters are replicated, or sharded over "model" (`parallel/tp.py`);
  * attention tokens may be sharded over "model" (`parallel/sp.py`).

Without a process group (one process, `initialize_distributed` not
called) `make_mesh` returns the {"data": 1, "model": 1} mesh, which needs no
rendezvous and makes every collective a no-op; with one, a `DeviceMesh` from
`init_device_mesh`. `Mesh.shape` is a dict, as the JAX mesh's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

PyTree = Any

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


class Mesh:
    """A ("data", "model") layout of the world's ranks. `device_mesh` is the
    torch `DeviceMesh`, or None for the one-process mesh; `shape` maps each
    axis to its size."""

    def __init__(self, device_mesh=None):
        self.device_mesh = device_mesh
        sizes = (1, 1) if device_mesh is None else tuple(device_mesh.shape)
        self.shape = dict(zip(AXES, sizes))

    def group(self, axis: str):
        """The process group of this rank's `axis` line, or None without a
        process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def __deepcopy__(self, memo):
        return self  # a copied model shares the mesh (and its groups)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ("data", "model") mesh over all ranks of the world (or the
    given list of ranks, which must be the whole world). Defaults to pure
    data parallelism: data = n_ranks / model."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = len(devices) if devices is not None else world
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if devices is not None and sorted(devices) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the world: got "
                         f"{list(devices)} of {world} ranks")
    if not dist.is_initialized():
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(_device_type(), (data, model),
                                 mesh_dim_names=AXES))


def batch_sharding(mesh: Mesh) -> list:
    """DTensor placements of a batch: the leading axis sharded over "data",
    replicated over "model"."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Replicate()]


def replicated(mesh: Mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate(), Replicate()]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n


def shard_batch(mesh: Mesh, batch: PyTree) -> PyTree:
    """This rank's slice of a global batch (every leaf's leading axis), by
    `distributed.process_batch_slice`."""
    from tpu_diffusion_torch.parallel.distributed import process_batch_slice
    if mesh.shape[DATA_AXIS] == 1:
        return batch
    return _tree_map(lambda x: x[process_batch_slice(x.shape[0], mesh)],
                     batch)


def replicate(mesh: Mesh, tree: PyTree) -> PyTree:
    """Every tensor of `tree` broadcast, in place, from the mesh's first
    rank to all others."""
    if mesh.device_mesh is None:
        return tree
    src = int(mesh.device_mesh.mesh.flatten()[0])

    def one(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src)
        return x

    return _tree_map(one, tree)
