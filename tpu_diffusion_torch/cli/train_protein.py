"""Protein C-alpha backbone diffusion training, in PyTorch.

Counterpart of `tpu_diffusion/cli/train_protein.py`, with its flags plus
`--device`:

    python -m tpu_diffusion_torch.cli.train_protein --num_steps 20000 ...

Diffuser: HoogeboomGraphSDE(N=250); model: GVPDenoiser (max_protein_length
112, (256, 64) hidden, 5 conv layers, 3 message GVPs and 1 feedforward);
loss: DSM + aux_weight * (backbone + distogram) below the t-cutoff; Adam at
a constant lr 1e-4 with clip 1.0 and EMA 0.999, in fp32. Batches come from
`protein.data.protein_batches` on the host: the SCOPe .npy files under
`--data_root` when there are any, else the synthetic helix chains.
Checkpoints `{params, ema, step}` under `<output_dir>/<name>/ckpt/` (the
newest three kept); a run restarts from the latest one, the EMA included.
Metrics go to `LocalWriter` every 20 steps, the flags to config.yaml. Runs on
the CUDA card unless `--device cpu`.
Under COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID each process is
one rank of a data-parallel mesh (`parallel/`).
"""

from __future__ import annotations

import argparse
import os

import torch

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.models.unet import resolve_device
from tpu_diffusion_torch.parallel.distributed import initialize_distributed
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.protein.data import get_protein_data, protein_batches
from tpu_diffusion_torch.protein.denoiser import GVPDenoiser
from tpu_diffusion_torch.protein.resdiff import resdiff_loss
from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE, ProteinBatch
from tpu_diffusion_torch.train.actions import PeriodicCallback
from tpu_diffusion_torch.train.checkpoint import CheckpointManager
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step)
from tpu_diffusion_torch.train.writers import LocalWriter


def build_model(args, device) -> GVPDenoiser:
    return GVPDenoiser(
        max_protein_length=args.max_len,
        n_h_node_feats=(args.node_scalars, args.node_vectors),
        n_h_edge_feats=(args.node_scalars, args.node_vectors),
        n_conv_layers=args.conv_layers,
        n_msg_layers=3, n_ff_layers=1,
        num_steps=args.diffusion_steps,
        remat=getattr(args, "remat", False), device=device)


def make_loss_fn(diffuser: HoogeboomGraphSDE, aux_weight: float = 0.25,
                 aux_cutoff: float = 0.25, distogram: str = "sequential"):
    """loss(model, generator, batch {"pos", "mask"}) -> the ResDiff total,
    t and the noise drawn from the generator."""

    def loss_fn(model, generator, batch):
        pb = ProteinBatch.from_positions(batch["pos"], batch["mask"])
        total, _ = resdiff_loss(generator, model, diffuser, pb,
                                aux_weight=aux_weight, aux_cutoff=aux_cutoff,
                                distogram=distogram)
        return total

    return loss_fn


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="results_protein")
    p.add_argument("--name", default="gvp")
    p.add_argument("--num_steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_len", type=int, default=112)
    p.add_argument("--node_scalars", type=int, default=256)
    p.add_argument("--node_vectors", type=int, default=64)
    p.add_argument("--conv_layers", type=int, default=5)
    p.add_argument("--diffusion_steps", type=int, default=250)
    p.add_argument("--aux_weight", type=float, default=0.25)
    p.add_argument("--aux_cutoff", type=float, default=0.25)
    p.add_argument("--distogram", default="sequential",
                   choices=["sequential", "dense"])
    p.add_argument("--remat", action="store_true",
                   help="recompute the GVP conv layers in the backward "
                        "(less memory, one more forward)")
    p.add_argument("--data_root", default="data/scope")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="0 -> num_steps // 10")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Train; returns the train state, the output directory and the
    parameter count."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device=device)
    mesh = make_mesh()  # every rank on "data"

    savedir = os.path.join(args.output_dir, args.name)
    os.makedirs(savedir, exist_ok=True)
    writer = LocalWriter(savedir)
    writer.log_hparams(vars(args))

    ds = get_protein_data(args.data_root, max_len=args.max_len,
                          seed=args.seed)
    print(f"[train_protein] {len(ds)} proteins "
          f"({'synthetic' if ds.synthetic else args.data_root}), "
          f"max_len {ds.max_len}")

    diffuser = HoogeboomGraphSDE(num_steps=args.diffusion_steps,
                                 device=device)
    torch.manual_seed(args.seed)  # the model's own initialisation
    model = build_model(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train_protein] {n_params / 1e6:.2f}M params, device={device}")

    optimizer = make_optimizer(model.parameters(), args.lr, warmup=0,
                               grad_clip=1.0, schedule="constant", mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(model, optimizer, generator)
    train_step = make_train_step(
        make_loss_fn(diffuser, args.aux_weight, args.aux_cutoff,
                     args.distogram), ema_decay=0.999)

    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"), maximum=3)
    # restart from the latest checkpoint when there is one, the EMA too:
    # a fresh EMA would blend ~0.999^k of the random init into every read
    restored, start = ckpt.load({"params": state.params,
                                 "ema": state.ema.params, "step": 0})
    if start:
        print(f"[train_protein] resuming from step {start}")
        with torch.no_grad():
            set_params(model, restored["params"])
            for k, v in state.ema.params.items():
                v.copy_(restored["ema"][k])
        state.step = start

    every = args.ckpt_every or max(args.num_steps // 10, 1)

    def save(step, state, **kw):
        ckpt.save(step, {"params": state.params, "ema": state.ema.params,
                         "step": step})

    callbacks = [
        PeriodicCallback(callback_fn=lambda step, metrics, **kw:
                         writer.write_scalars(step, metrics),
                         every_steps=20),
        PeriodicCallback(callback_fn=save, every_steps=every),
    ]
    batches = protein_batches(ds, args.batch_size, seed=args.seed)
    trainer = Trainer(train_step, state, batches, mesh=mesh,
                      callbacks=callbacks)
    print(f"[train_protein] {trainer.route()}")
    state = trainer.fit(max(args.num_steps - start, 0))
    save(state.step, state)
    writer.flush()
    print(f"[train_protein] done at step {state.step}")
    return {"state": state, "output_dir": savedir, "n_params": n_params}


if __name__ == "__main__":
    main()
