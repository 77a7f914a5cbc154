"""Motif-scaffolded protein generation, in PyTorch.

Counterpart of `tpu_diffusion/cli/sample_protein.py`, with its flags plus
`--device`: load the EMA weights of a `train_protein` checkpoint, build a
Structconditioner around the motif (from `--motif_npy`, or a synthetic
8-residue helix fragment), draw blob priors with lengths from the dataset
(a numpy generator), run the guided reverse chain (the conditioner active
for step < cond_start_step, default diffusion_steps // 2; gs 1500), and
write `sample_XXXX.npy` and `.pdb` in Angstrom, `cond_losses.npy` and
`summary.json`. `--save_plots` (matplotlib) adds structure PNGs and a
trajectory GIF of the first batch. Runs on the CUDA card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.cli.train_protein import build_model
from tpu_diffusion_torch.models.unet import resolve_device
from tpu_diffusion_torch.protein.conditioner import (
    Structconditioner, place_indices_block_within_bounds)
from tpu_diffusion_torch.protein.data import (COORD_SCALE, get_protein_data,
                                              synthetic_ca_chains)
from tpu_diffusion_torch.protein.pdb import write_ca_pdb
from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.train.checkpoint import CheckpointManager


def load_motif(path, indices_path, max_len: int, seed: int = 0,
               device="cpu"):
    """Motif coordinates (scaled, centred) and indices centred in the
    chain. Falls back to a synthetic 8-residue helix fragment when no .npy
    is given."""
    if path and os.path.exists(path):
        coords = np.load(path).astype(np.float32) * COORD_SCALE
        coords = coords - coords.mean(0, keepdims=True)
        if indices_path and os.path.exists(indices_path):
            idx = np.load(indices_path).astype(np.int32)
        else:
            idx = np.arange(len(coords), dtype=np.int32)
    else:
        frag = synthetic_ca_chains(1, max_len=16, min_len=8, seed=seed)
        m = 8
        coords = frag.positions[0][:m]
        coords = coords - coords.mean(0, keepdims=True)
        idx = np.arange(m, dtype=np.int32)
    idx = place_indices_block_within_bounds(torch.from_numpy(idx), max_len)
    return (torch.as_tensor(coords, device=device),
            idx.to(device=device, dtype=torch.long))


def main(argv=None) -> dict:
    """Sample; returns the summary, the output directory and the last
    batch's positions and mask (on the CPU)."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", default="results_protein/gvp/ckpt")
    p.add_argument("--output_dir", default="results_protein/samples")
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--max_len", type=int, default=112)
    p.add_argument("--node_scalars", type=int, default=256)
    p.add_argument("--node_vectors", type=int, default=64)
    p.add_argument("--conv_layers", type=int, default=5)
    p.add_argument("--diffusion_steps", type=int, default=250)
    p.add_argument("--motif_npy", default=None)
    p.add_argument("--motif_indices_npy", default=None)
    p.add_argument("--guidance_scale", type=float, default=1500.0)
    p.add_argument("--cond_start_step", type=int, default=0,
                   help="conditioner active for step < this; 0 -> "
                        "diffusion_steps // 2 (guidance at t near 1, where "
                        "beta is large, explodes under the gs*a*(1-a) law)")
    p.add_argument("--no_conditioner", action="store_true")
    p.add_argument("--data_root", default="data/scope")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_plots", action="store_true",
                   help="3D structure PNG per sample + a trajectory GIF for "
                        "the first batch (needs matplotlib)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.cond_start_step <= 0:
        args.cond_start_step = args.diffusion_steps // 2
    torch.manual_seed(0)
    model = build_model(args, device).eval()
    diffuser = HoogeboomGraphSDE(num_steps=args.diffusion_steps,
                                 device=device)
    params = dict(model.named_parameters())
    assets, step = CheckpointManager(args.ckpt_dir).load(
        {"params": params, "ema": params, "step": 0})
    with torch.no_grad():
        set_params(model, assets["ema"])
    # the guidance differentiates with respect to the positions only
    model.requires_grad_(False)
    print(f"[sample_protein] restored step {step}")

    conditioner = None
    if not args.no_conditioner:
        motif_pos, motif_idx = load_motif(args.motif_npy,
                                          args.motif_indices_npy,
                                          args.max_len, args.seed, device)
        conditioner = Structconditioner(
            motif_pos=motif_pos, motif_indices=motif_idx,
            guidance_scale=args.guidance_scale)
        print(f"[sample_protein] motif: {motif_pos.shape[0]} residues at "
              f"{motif_idx.tolist()[:8]}...")

    # lengths drawn from the validation set
    ds = get_protein_data(args.data_root, max_len=args.max_len,
                          seed=args.seed + 1)

    def score_model(batch, t):
        return model(batch, t)

    # the unguided chain replays one captured step (sampling/graph.py); the
    # guided one stays eager (its SVD reads the card on the host)
    graphs = GraphCache(model)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    saved = 0
    all_losses = []
    first_batch = True
    while saved < args.num_samples:
        lengths = torch.as_tensor(rng.choice(ds.lengths, args.batch_size),
                                  device=device)
        blob = diffuser.sample_blob(generator, args.batch_size, args.max_len,
                                    lengths=lengths)
        plots = args.save_plots and first_batch
        out = diffuser.reverse_diffusion_sampling(
            generator, blob, score_model, conditioner=conditioner,
            cond_start_step=args.cond_start_step, save_trajectory=plots,
            graphs=None if plots else graphs)
        if plots:
            traj, out = out
            from tpu_diffusion_torch.eval.plotting import trajectory_gif
            t0 = traj[:, 0].cpu().numpy()
            m0 = out.mask[0].cpu().numpy()
            trajectory_gif(t0[:, m0], os.path.join(
                args.output_dir, "trajectory_0.gif"), fps=10,
                stride=max(len(t0) // 40, 1))
        pos = out.pos.cpu().numpy()
        mask = out.mask.cpu().numpy()
        if conditioner is not None:
            all_losses.extend(conditioner.final_loss(out).cpu().tolist())
        for i in range(args.batch_size):
            if saved >= args.num_samples:
                break
            coords = pos[i][mask[i]] / COORD_SCALE  # back to Angstrom
            np.save(os.path.join(args.output_dir,
                                 f"sample_{saved:04d}.npy"), coords)
            write_ca_pdb(coords, os.path.join(
                args.output_dir, f"sample_{saved:04d}.pdb"))
            if plots and i < 4:
                from tpu_diffusion_torch.eval.plotting import plot_structure
                fig = plot_structure(coords, f"sample {saved}")
                fig.savefig(os.path.join(args.output_dir,
                                         f"sample_{saved:04d}.png"))
            saved += 1
        first_batch = False
        print(f"[sample_protein] {saved}/{args.num_samples}")

    summary = {"num_samples": saved, "ckpt_step": int(step),
               "guidance_scale": args.guidance_scale
               if conditioner else None}
    if all_losses:
        summary["cond_loss_mean"] = float(np.mean(all_losses))
        summary["cond_loss_std"] = float(np.std(all_losses))
        np.save(os.path.join(args.output_dir, "cond_losses.npy"),
                np.asarray(all_losses))
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[sample_protein]", json.dumps(summary))
    return {"summary": summary, "output_dir": args.output_dir,
            "pos": torch.from_numpy(pos), "mask": torch.from_numpy(mask)}


if __name__ == "__main__":
    main()
