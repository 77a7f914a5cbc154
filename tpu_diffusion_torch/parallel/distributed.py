"""Multi-process initialisation and cross-rank batch utilities.

Counterpart of `tpu_diffusion/parallel/distributed.py`. One process per
device (`torch.distributed` with NCCL on CUDA, gloo on the CPU); every rank
of a run calls `initialize_distributed()` with the same COORDINATOR_ADDRESS
and NUM_PROCESSES and its own PROCESS_ID, then builds one global mesh:

    initialize_distributed()          # no-op for a single process
    mesh = make_mesh(model=2)         # over every rank of the world
    batch = host_local_to_global(mesh, local_batch)
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from tpu_diffusion_torch.parallel.mesh import DATA_AXIS, Mesh, _tree_map

PyTree = Any


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> bool:
    """Join the process group when running multi-process; returns True if
    distributed mode is active. Reads COORDINATOR_ADDRESS ("host:port"),
    NUM_PROCESSES and PROCESS_ID when the arguments are None, and does
    nothing for a single process with no coordinator. The backend is NCCL
    for a CUDA `device` (each rank then takes the card `rank % count`) and
    gloo for the CPU. `timeout` (seconds) bounds every collective."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a "
                         "COORDINATOR_ADDRESS (host:port)")
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)
    return True


def host_local_to_global(mesh: Mesh, local_batch: PyTree,
                         axis: str = DATA_AXIS) -> PyTree:
    """Assemble the ranks' batch shards into global `DTensor`s, sharded
    over `axis` and replicated over the other axis. Every rank's shard must
    have the same shape; the global leading size is the shard's times the
    axis size. Without a process group the local batch is the global one."""
    if mesh.device_mesh is None:
        return local_batch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    placements = [Shard(0) if a == axis else Replicate()
                  for a in mesh.shape]
    group, n = mesh.group(axis), mesh.shape[axis]

    def assemble(x):
        x = torch.as_tensor(x)
        sizes = [None] * n
        dist.all_gather_object(sizes, tuple(x.shape), group=group)
        if len(set(sizes)) != 1:
            raise ValueError(f"the ranks' shards differ in shape: {sizes}")
        shape = (x.shape[0] * n,) + tuple(x.shape[1:])
        return DTensor.from_local(
            x, mesh.device_mesh, placements, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    return _tree_map(assemble, local_batch)


def process_batch_slice(global_batch: int,
                        mesh: Optional[Mesh] = None) -> slice:
    """This rank's slice of a global batch partitioned over the "data" ranks
    of `mesh` (without a mesh: over every rank of the world)."""
    if mesh is not None:
        n, i = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(
            f"global_batch={global_batch} not divisible by "
            f"process_count={n} — the remainder would be silently "
            f"dropped from every step")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
