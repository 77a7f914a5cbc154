"""What each rank of a spawned gloo world runs in tests/test_torch_parallel*.

Imports only torch and the port: a rank starts without JAX. Every function
here is called on every rank (`parallel/dryrun.py:run_world`) and returns a
picklable result.
"""

import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from tpu_diffusion_torch.cli import train_cfm_conditional as cfmc
from tpu_diffusion_torch.losses.cfm import get_matcher
from tpu_diffusion_torch.models.unet import SuperResModelWrapper
from tpu_diffusion_torch.parallel import sp
from tpu_diffusion_torch.parallel.distributed import host_local_to_global
from tpu_diffusion_torch.parallel.dryrun import dryrun
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.parallel.tp import (SHARD_ATTR, full_tensor,
                                             local_like, opt_state_tree,
                                             stored_bytes)
from tpu_diffusion_torch.train.checkpoint import CheckpointManager
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step)

DIM = (28, 28, 1)
PAD = -2.0


def superres_step(state_dict, batch, draws, mesh=None,
                  tensor_parallel=False):
    """One CFM super-resolution train step of the CLI's mnist model at
    num_channels 8, in fp32, through the CLI's own loss, on the global
    batch `batch` with the global draws (x0, t, eps, cond) handed in
    beside it, so each "data" rank's slice of the batch comes with its
    slice of the draws. Returns (state, trainer, loss, grad_norm, replica
    parameter bytes)."""
    model = SuperResModelWrapper(DIM, num_channels=8,
                                 attention_resolutions="14",
                                 attention_impl="dense", dtype=torch.float32,
                                 device="cpu", sp_mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    replica = stored_bytes(model.parameters())
    loss = cfmc.make_loss_fn(get_matcher("icfm", sigma=0.0),
                             cfmc.make_condition_fn("superres", DIM, 14, PAD),
                             "superres", False, PAD)
    state = TrainState.create(
        model, make_optimizer(model.parameters(), 1e-3, warmup=0,
                              grad_clip=1.0, mesh=mesh),
        torch.Generator().manual_seed(0))
    step = make_train_step(lambda m, g, b: loss(
        m, g, b["x1"], **{k: b[k] for k in draws}))
    trainer = Trainer(step, state, iter([{"x1": batch, **draws}]), mesh=mesh,
                      tensor_parallel=tensor_parallel)
    seen = []
    trainer.fit(1, metrics_hook=lambda s, m: seen.append(m))
    return state, trainer, seen[0]["loss"], seen[0]["grad_norm"], replica


def _gathered(state):
    """The full parameters and the full first Adam moments (0.1 times the
    clipped gradient after one update), by name."""
    return ({k: full_tensor(v).detach().numpy()
             for k, v in state.params.items()},
            {k: full_tensor(m["exp_avg"]).numpy()
             for k, m in opt_state_tree(state).items()})


def tp_sp_world(state_dict, batch, draws):
    """The TP+SP step on a (data 1 x model 2) mesh, a checkpoint of its
    state restored in place, and the dry run, on this rank."""
    mesh = make_mesh(model=2)
    sp.reset_sp_decisions()
    state, trainer, loss, gnorm, replica = superres_step(
        state_dict, batch, draws, mesh=mesh, tensor_parallel=True)
    decisions = sp.sp_decisions()
    params, mu = _gathered(state)
    live = {"params": state.params, "ema": state.ema.params,
            "opt_state": opt_state_tree(state)}
    name = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    mgr = CheckpointManager(name[0], maximum=1)
    mgr.save(1, {**live, "step": 1})
    restored, step = mgr.load(None)
    mgr.close()
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(name[0])
    bitwise, shapes_kept = True, True
    for tree in ("params", "ema"):
        for k, v in live[tree].items():
            back = local_like(restored[tree][k], v)
            shapes_kept &= back.shape == v.shape
            bitwise &= torch.equal(back, v.detach())
    for k, moments in live["opt_state"].items():
        for key, v in moments.items():
            back = local_like(restored["opt_state"][k][key], v)
            shapes_kept &= back.shape == v.shape
            bitwise &= torch.equal(back, v)
    n_sharded = sum(hasattr(p, SHARD_ATTR) for p in state.model.parameters())
    return {"loss": loss, "grad_norm": gnorm, "params": params, "mu": mu,
            "decisions": decisions, "replica_bytes": replica,
            "stored_bytes": stored_bytes(state.model.parameters()),
            "n_sharded": n_sharded, "n_trainer_sharded": trainer.n_sharded,
            "restore_step": step, "restore_bitwise": bitwise,
            "restore_shapes_kept": shapes_kept,
            "mesh": dict(mesh.shape), "dryrun": dryrun("cpu")}


def data_parallel_step(state_dict, batch, draws):
    """The same step on a (data 2 x model 1) mesh: each rank trains on its
    half of the batch and of the draws, and the gradients are averaged over
    "data"."""
    mesh = make_mesh(data=2, model=1)
    state, _, loss, gnorm, _ = superres_step(state_dict, batch, draws,
                                             mesh=mesh)
    params, mu = _gathered(state)
    return {"loss": loss, "grad_norm": gnorm, "params": params, "mu": mu,
            "mesh": dict(mesh.shape)}


def replicated_step(state_dict, batch, draws):
    """The same step with no mesh, in one process (no process group)."""
    state, _, loss, gnorm, _ = superres_step(state_dict, batch, draws)
    params, mu = _gathered(state)
    return {"loss": loss, "grad_norm": gnorm, "params": params, "mu": mu}


def sampler_slices(seed):
    """This rank's slices of the device-cache samplers' draws on a
    (data n x model 1) mesh."""
    from tpu_diffusion_torch.data.device_cache import (make_cfm_pair_sampler,
                                                       make_protein_sampler,
                                                       sample_batch, stage)
    mesh = make_mesh()
    rng = np.random.default_rng(seed)
    images = stage(rng.normal(size=(16, 4, 4, 2)).astype(np.float32), "cpu",
                   mesh=mesh)
    g = torch.Generator().manual_seed(seed)
    batch = sample_batch(images, g, 8, flip=True, mesh=mesh)
    x0, x1 = make_cfm_pair_sampler(images, 8, mesh=mesh)(g)
    protein = make_protein_sampler(rng.normal(size=(6, 5, 3)),
                                   rng.integers(2, 6, 6), 8, "cpu",
                                   mesh=mesh)(g)
    glob = host_local_to_global(mesh, {"x": batch})["x"]
    return {"slices": [t.numpy() for t in (batch, x0, x1, protein["pos"],
                                           protein["mask"])],
            "global_shape": tuple(glob.shape),
            "global": glob.full_tensor().numpy()}


def two_rank_world(state_dict, batch, draws, seed):
    """Everything the 2-rank test world checks, in one spawn."""
    return {**tp_sp_world(state_dict, batch, draws),
            "data_parallel": data_parallel_step(state_dict, batch, draws),
            "samples": sampler_slices(seed)}
