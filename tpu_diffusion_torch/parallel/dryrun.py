"""A sharded dry run of the training stack over a world of ranks.

Counterpart of `__graft_entry__.py:_dryrun_body`. On a ("data", "model")
mesh with model 2 (when the rank count is even), the 16px InPainting /
Amortized UNet trains with its parameters sharded over "model" and its
attention tokens on the ring: two steps (the ring must engage), a
checkpoint saved and restored bitwise and still sharded, then
`fit_scanned` for 4 steps in chunks of 3 from the device-resident
sampler. The first rank prints one line in the JAX format:

    [dryrun_multichip] mesh={'data': 2, 'model': 2} tp_sharded_params=...
        sp=ring(x4) steps=2 restore=bitwise scanned=4 loss=... ok

    python -m tpu_diffusion_torch.parallel.dryrun --nproc 4 --device cpu

spawns the ranks (gloo on the CPU, NCCL with `--device cuda`, one card per
rank). `run_world` spawns a world for any function (the tests use it).
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from tpu_diffusion_torch.parallel.distributed import initialize_distributed


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, nprocs, port, device, target, args, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", nprocs, rank, device=device,
                           timeout=300)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(target: str, nprocs: int, device="cpu", args=()) -> list:
    """Run `module:function(*args)` on `nprocs` spawned ranks of one world
    (gloo on the CPU, NCCL on CUDA); returns each rank's result, in rank
    order. A rank that raises makes this raise."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main, args=(nprocs, free_port(),
                                             str(device), target,
                                             tuple(args), out_dir),
                           nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]


def _shared_tempdir():
    """(the first rank's TemporaryDirectory or None, its path): a
    temporary directory the first rank makes and every rank uses."""
    made = tempfile.TemporaryDirectory() if dist.get_rank() == 0 else None
    name = [made.name if made else None]
    dist.broadcast_object_list(name, src=0)
    return made, name[0]


def dryrun(device="cpu") -> dict:
    """The dry run on this rank (every rank of the world calls it).
    Returns {"line", "mesh", "n_sharded", "sp_engaged", "loss",
    "restore_bitwise", "stored_bytes", "replica_bytes"}."""
    from tpu_diffusion_torch.conditioning.guidance import Amortized
    from tpu_diffusion_torch.conditioning.likelihoods import InPainting
    from tpu_diffusion_torch.core.schedules import DDPM
    from tpu_diffusion_torch.data.device_cache import sample_batch, stage
    from tpu_diffusion_torch.losses.ddpm import get_loss_function
    from tpu_diffusion_torch.models.unet import create_model
    from tpu_diffusion_torch.parallel import sp
    from tpu_diffusion_torch.parallel.mesh import make_mesh
    from tpu_diffusion_torch.parallel.tp import (SHARD_ATTR, local_like,
                                                 opt_state_tree,
                                                 shard_state_, stored_bytes)
    from tpu_diffusion_torch.train.checkpoint import CheckpointManager
    from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                                   make_optimizer,
                                                   make_train_step)

    n = dist.get_world_size()
    model_axis = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(model=model_axis)
    device = torch.device(device)
    ddpm = DDPM.create(100).to(device)
    lik = InPainting(patch_size=6, pad_value=-2.0)
    cond = Amortized(p_cond=0.9)

    def new_state():
        torch.manual_seed(0)
        model = create_model(
            image_size=16, num_channels=8, num_res_blocks=1, in_channels=2,
            out_channels=1, channel_mult=(1, 2), attention_resolutions="8",
            num_heads=2, use_scale_shift_norm=True, attention_impl="auto",
            dtype=torch.float32, device=device,
            sp_mesh=mesh if model_axis > 1 else None)
        opt = make_optimizer(model.parameters(), 1e-3, warmup=10,
                             grad_clip=1.0, mesh=mesh)
        return TrainState.create(
            model, opt, torch.Generator(device=device).manual_seed(0))

    def loss_fn(model, generator, batch):
        def net(x, t):
            return model(x, t, generator=generator)
        return get_loss_function(net, ddpm, cond, lik)[0](generator, batch)

    train_step = make_train_step(loss_fn, ema_decay=0.999)
    data = mesh.shape["data"]
    batch = np.random.default_rng(0).normal(
        size=(4 * data, 16, 16, 1)).astype(np.float32)

    state = new_state()
    replica_bytes = stored_bytes(state.model.parameters())
    trainer = Trainer(train_step, state, iter([batch, batch]), mesh=mesh)
    n_sharded = 0
    if model_axis > 1:  # the small UNet: a lower sharding threshold
        n_sharded = shard_state_(mesh, state, min_shard_elems=64)
        _check(n_sharded > 0, "no parameters sharded over the model axis")
    sp.reset_sp_decisions()
    losses = []
    trainer.fit(1, metrics_hook=lambda s, m: losses.append(m["loss"]))
    engaged = [d for d in sp.sp_decisions() if d["engaged"]]
    if model_axis > 1:
        _check(engaged, "sequence parallelism never engaged: "
               f"{sp.sp_decisions()}")
    state = trainer.fit(1, metrics_hook=lambda s, m: losses.append(
        m["loss"]))
    loss = losses[-1]
    _check(np.isfinite(loss) and state.step == 2,
           f"loss {loss} at step {state.step}")

    # save -> restore into the sharded layout, bitwise
    made, ckdir = _shared_tempdir()
    live = {"params": state.params, "ema": state.ema.params,
            "opt_state": opt_state_tree(state)}
    mgr = CheckpointManager(ckdir, maximum=1)
    mgr.save(2, {**live, "step": 2})
    restored, step = mgr.load(None)
    mgr.close()
    dist.barrier()
    if made is not None:
        made.cleanup()
    _check(step == 2 and restored["step"] == 2, f"restored step {step}")

    def back(full, like):
        if isinstance(like, dict):
            return {k: back(full[k], v) for k, v in like.items()}
        return local_like(full, like)

    max_err = 0.0
    n_restored_sharded = 0
    for tree in ("params", "ema", "opt_state"):
        got = back(restored[tree], live[tree])
        flat_got, flat_live = _leaves(got), _leaves(live[tree])
        for a, b in zip(flat_got, flat_live):
            _check(a.shape == b.shape, f"restored {tree} in shape "
                   f"{tuple(a.shape)}, held {tuple(b.shape)}")
            max_err = max(max_err, float((a.double() - b.detach().cpu()
                                          .double()).abs().max()))
        if tree == "params":
            n_restored_sharded = sum(hasattr(b, SHARD_ATTR)
                                     for b in flat_live)
    _check(max_err == 0.0, f"restore not bitwise: max |delta|={max_err}")
    _check(n_restored_sharded == n_sharded,
           f"restore changed shardings: {n_restored_sharded} vs {n_sharded}")

    # the device-resident scanned path over the same mesh
    images = stage(np.random.default_rng(1).normal(
        size=(32, 16, 16, 1)).astype(np.float32), device, mesh=mesh)
    scanned = Trainer(train_step, new_state(), iter(()), mesh=mesh,
                      tensor_parallel=model_axis > 1).fit_scanned(
        4, lambda g: sample_batch(images, g, 4 * data, mesh=mesh), chunk=3,
        base_seed=2)
    _check(scanned.step == 4 and all(bool(torch.isfinite(p).all())
                                     for p in scanned.model.parameters()),
           f"fit_scanned ended at step {scanned.step}, or not finite")

    line = (f"[dryrun_multichip] mesh={dict(mesh.shape)} "
            f"tp_sharded_params={n_sharded} "
            f"sp={'ring(x' + str(len(engaged)) + ')' if engaged else 'off'} "
            f"steps=2 restore=bitwise scanned=4 loss={loss:.4f} ok")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return {"line": line, "mesh": dict(mesh.shape), "n_sharded": n_sharded,
            "sp_engaged": len(engaged), "loss": loss,
            "restore_bitwise": max_err == 0.0,
            "stored_bytes": stored_bytes(state.model.parameters()),
            "replica_bytes": replica_bytes}


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cpu",
                   help="cpu (gloo) or cuda (NCCL, one card per rank)")
    args = p.parse_args(argv)
    return run_world("tpu_diffusion_torch.parallel.dryrun:dryrun",
                     args.nproc, args.device,
                     (args.device,))


if __name__ == "__main__":
    main()
