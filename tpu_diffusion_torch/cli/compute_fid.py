"""FID evaluation of a trained CFM model, in PyTorch.

Counterpart of `tpu_diffusion/cli/compute_fid.py`, with its flags plus
`--device`:

    python -m tpu_diffusion_torch.cli.compute_fid --model otcfm \\
        --input_dir results --integration_method dopri5 --num_gen 50000

Protocol (the reference's compute_fid.py:28-31, 73-100): restore the EMA
(or, with `--use_ema false`, the live) parameters from the newest
checkpoint of `cli/train_cifar10.py` under `<input_dir>/<model>/ckpt/`,
integrate the velocity field from noise (dopri5 with atol = rtol = `--tol`,
or a fixed-step method over `--integration_steps`), quantize to uint8 and
back, and compute the Frechet distance against the dataset's train split
with `--features` (`eval/fid.py`; the result carries its caveat fields).
The train split's statistics are cached in
`<input_dir>/real_stats_torch_<dataset>_<features>_<H>x<W>x<C>.npz` (the
port's features are not the JAX package's, hence a file of its own). Runs
on the CUDA card unless `--device cpu`.

dopri5 runs the early-exit controller (`--dopri5_fixed_trip auto`, the
platform's kwargs, or `false`) as a graphed chain with a budget of
`DOPRI5_MAX_STEPS` trips; `--dopri5_fixed_trip true` calibrates a trip
budget on a batch-2 probe of `--seed + 1` noise and integrates every batch
by `Dopri5Chunked` in segments of `--dopri5_chunk` trips, and the result
then carries `dopri5_trip_budget` and `dopri5_chunk`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.cli.train_cifar10 import build_model
from tpu_diffusion_torch.data.registry import epoch_batches, get_dataset
from tpu_diffusion_torch.eval.fid import FID, fid_caveat, make_feature_fn
from tpu_diffusion_torch.models.unet import resolve_device
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.sampling.ode import (Dopri5Chunked,
                                               calibrate_dopri5_steps,
                                               dopri5_platform_kwargs,
                                               dopri5_truncated, odeint)
from tpu_diffusion_torch.train.checkpoint import CheckpointManager

DOPRI5_MAX_STEPS = 1000  # the early exit's trip budget (`odeint_dopri5`'s)


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] float -> uint8 -> [-1,1] float (the reference quantizes
    generated images to uint8 before FID, compute_fid.py:88-91)."""
    u8 = torch.clamp((x + 1.0) * 127.5, 0, 255).to(torch.uint8)
    return u8.float() / 127.5 - 1.0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="otcfm")
    p.add_argument("--input_dir", default="results")
    p.add_argument("--dataset", default="cifar10")
    p.add_argument("--num_channel", type=int, default=128)
    p.add_argument("--integration_method", default="dopri5",
                   choices=["dopri5", "euler", "heun", "midpoint", "rk4"])
    p.add_argument("--integration_steps", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--num_gen", type=int, default=50000)
    p.add_argument("--batch_size_fid", type=int, default=1024)
    p.add_argument("--features", default="random_conv",
                   choices=["random_conv", "inception"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dopri5_fixed_trip", default="auto",
                   choices=["auto", "true", "false"],
                   help="true: a calibrated fixed trip budget integrated "
                        "by Dopri5Chunked; auto (the platform's choice) "
                        "and false: the early-exit controller")
    p.add_argument("--dopri5_chunk", type=int, default=16,
                   help="trips per segment of the fixed-trip dopri5 (one "
                        "replay of a captured body on the card)")
    p.add_argument("--use_ema", default="true", choices=["true", "false"],
                   help="sample with the EMA weights (reference protocol); "
                        "'false' uses the live params (useful for short "
                        "runs where the 0.9999 EMA has not converged)")
    p.add_argument("--data_root", default="data")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    ds = get_dataset(args.dataset)(args.data_root, train=True)
    h, w, c = ds.shape
    torch.manual_seed(0)  # the initialisation used when there is no ckpt
    model = build_model(image_size=h, num_channels=args.num_channel,
                        channels=c, device=device)
    ckpt_dir = os.path.join(args.input_dir, args.model, "ckpt")
    own = {k: v.detach() for k, v in model.named_parameters()}
    assets, step = CheckpointManager(ckpt_dir).load(
        {"params": own, "ema": own, "step": 0})
    set_params(model, assets["ema" if args.use_ema == "true" else "params"])
    model.eval().requires_grad_(False)
    print(f"[compute_fid] restored step {step} from {ckpt_dir}", flush=True)

    # the integrators replay captured bodies (sampling/graph.py)
    graphs = GraphCache(model)
    dopri5_kwargs = {}
    if args.integration_method == "dopri5":
        dopri5_kwargs = {"max_steps": DOPRI5_MAX_STEPS}
        if args.dopri5_fixed_trip == "auto":
            dopri5_kwargs.update(dopri5_platform_kwargs())
        elif args.dopri5_fixed_trip == "true":
            # the fixed trips are all paid: size the budget from one probe
            # of the early-exit controller, on the device of the run
            probe = torch.randn((2, h, w, c), device=device,
                                generator=torch.Generator(device).manual_seed(
                                    args.seed + 1))
            with torch.no_grad():
                budget = calibrate_dopri5_steps(model, probe, rtol=args.tol,
                                                atol=args.tol)
            dopri5_kwargs = {"fixed_trip_count": True, "max_steps": budget}
            print(f"[compute_fid] dopri5 trip budget calibrated to {budget}",
                  flush=True)
    budget = dopri5_kwargs.get("max_steps")
    if dopri5_kwargs.get("fixed_trip_count"):
        chunked = Dopri5Chunked(model, rtol=args.tol, atol=args.tol,
                                max_steps=budget,
                                chunk_steps=args.dopri5_chunk, graphs=graphs)
        print(f"[compute_fid] {chunked.n_segments} segments x "
              f"{chunked.chunk_steps} trips per batch", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)

    @torch.no_grad()
    def gen_batch():
        noise = torch.randn((args.batch_size_fid, h, w, c),
                            generator=generator, device=device)
        if dopri5_kwargs.get("fixed_trip_count"):
            x1, nfe = chunked(noise)
        elif args.integration_method == "dopri5":
            x1, nfe = odeint(model, noise, method="dopri5", rtol=args.tol,
                             atol=args.tol, graphs=graphs, **dopri5_kwargs)
        else:
            x1, nfe = odeint(model, noise, method=args.integration_method,
                             num_steps=args.integration_steps, graphs=graphs)
        return quantize_roundtrip(torch.clamp(x1, -1, 1)), nfe

    fid = FID(make_feature_fn(args.features, channels=c, device=device))
    stats_path = os.path.join(
        args.input_dir,
        f"real_stats_torch_{args.dataset}_{args.features}_{h}x{w}x{c}.npz")
    if os.path.exists(stats_path):
        z = np.load(stats_path)
        fid.set_real_statistics(z["mu"], z["sigma"])
        print(f"[compute_fid] real stats from cache {stats_path}",
              flush=True)
    else:
        for batch in epoch_batches(ds, args.batch_size_fid):
            fid.update(batch, real=True)
        mu, sigma = fid.real_statistics()
        np.savez(stats_path, mu=mu, sigma=sigma)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    nfes = []
    n_batches = -(-args.num_gen // args.batch_size_fid)
    for i in range(n_batches):
        imgs, nfe = gen_batch()
        nfes.append(nfe)
        if budget and dopri5_truncated(nfe, budget):
            print(f"[compute_fid] WARNING: dopri5 exhausted its "
                  f"{budget}-trip budget (nfe={nfe}): the trajectory may "
                  f"be unconverged")
        fid.update(imgs, real=False)
        if i % 5 == 0:
            print(f"[compute_fid] generated "
                  f"{min((i + 1) * args.batch_size_fid, args.num_gen)}"
                  f"/{args.num_gen}", flush=True)

    result = {"fid": fid.compute(), "features": args.features,
              "step": int(step), "num_gen": n_batches * args.batch_size_fid,
              "mean_nfe": sum(nfes) / n_batches,
              "method": args.integration_method,
              "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                                 if device.type == "cuda" else None)}
    if args.integration_method == "dopri5":
        result["tol"] = args.tol
        result["dopri5_truncated"] = any(
            dopri5_truncated(n, budget) for n in nfes)
    if dopri5_kwargs.get("fixed_trip_count"):
        result["dopri5_trip_budget"] = budget
        result["dopri5_chunk"] = args.dopri5_chunk
    result.update(fid_caveat(args.features,
                             synthetic_data=getattr(ds, "synthetic", False)))
    print(json.dumps(result))
    out = os.path.join(args.input_dir, args.model,
                       f"fid_{args.features}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
