"""Conditional CFM training, inpainting and super-resolution, in PyTorch.

Counterpart of `tpu_diffusion/cli/train_cfm_conditional.py`, with its flags
plus `--device`:

    python -m tpu_diffusion_torch.cli.train_cfm_conditional \\
        --task superres --dataset synthetic256 --batch_size 8

  * `--task inpaint`: a random patch blanked to `--pad_value` is the
    condition, concatenated to x (`InPaintModelWrapper`); with
    `--weighted_loss` the squared error inside the patch weighs 10x
    (the reference's `mnist/train_mnist2.py:176-193`);
  * `--task superres`: the condition is x bilinearly downsampled by
    `--low_res_factor`, resized back up inside `SuperResModelWrapper`.

Datasets: mnist (28x28, 32 channels, attention at 14), flowers and celeba
(64x64, 128 channels, attention at 16), and synthetic256, the 4x
super-resolution config (256x256, channel_mult (1,1,2,2,4,4), attention at
32/16/8 with 4 heads: 1024 tokens of 64 channels per head at 32x32, which
`--attention_impl auto` sends to the flash kernels). Every
num_steps / `--eval_every_div` steps and at the end, the EMA model samples
the test images' conditions by the ODE (`--eval_method`; dopri5 at tol
1e-5) and MSE / PSNR / SSIM / NFE go to `results_per_step.json`; the final
eval writes `results.json`, image grids and a checkpoint {params, ema,
step} under `<output_dir>/<dataset>_<task>_<model>/ckpt/`. LPIPS, which the
reference also reports, needs pretrained VGG weights that the repo does not
hold, and is left out, as the JAX CLI leaves it out without them.
`--model_axis` sets the mesh's "model" axis (the parameters sharded over it
when > 1) and `--sequence_parallel` runs attention as a ring over it; under
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID each process is one rank.
Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.cli.train_cifar10 import ATTENTION_IMPLS
from tpu_diffusion_torch.conditioning.likelihoods import (InPainting,
                                                          resize_bilinear)
from tpu_diffusion_torch.data.registry import get_dataset, infinite_batches
from tpu_diffusion_torch.eval.metrics import mse, psnr, ssim
from tpu_diffusion_torch.losses.cfm import get_matcher
from tpu_diffusion_torch.models.unet import (InPaintModelWrapper,
                                             SuperResModelWrapper,
                                             resolve_device)
from tpu_diffusion_torch.parallel.distributed import initialize_distributed
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.sampling.ode import odeint
from tpu_diffusion_torch.train.actions import PeriodicCallback
from tpu_diffusion_torch.train.checkpoint import CheckpointManager
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step)
from tpu_diffusion_torch.train.writers import LocalWriter

_IMAGE_SIZES = {"mnist": 28, "flowers": 64, "celeba": 64,
                "synthetic256": 256}


def build(task: str, dataset: str, attention_impl: str = "auto",
          num_channels: int = 0, device="cuda", sp_mesh=None):
    """(wrapper, (H, W, C)) of the dataset's config; `attention_impl` in
    the port's names; `sp_mesh` for ring attention."""
    image_size = _IMAGE_SIZES.get(dataset, 64)
    channels = 1 if dataset == "mnist" else 3
    num_channels = num_channels or (32 if dataset == "mnist" else 128)
    dim = (image_size, image_size, channels)
    if image_size >= 256:
        # the 4x SR stretch config: a deeper multiplier stack, attention at
        # the 32/16/8 token grids (T up to 1024)
        attn = "32,16,8"
        mult = (1, 1, 2, 2, 4, 4)
    else:
        attn = "16" if image_size > 28 else "14"
        mult = None
    cls = InPaintModelWrapper if task == "inpaint" else SuperResModelWrapper
    model = cls(dim=dim, num_channels=num_channels, channel_mult=mult,
                attention_resolutions=attn, attention_impl=attention_impl,
                device=device, sp_mesh=sp_mesh)
    return model, dim


def make_condition_fn(task: str, dim, patch_size: int, pad_value: float,
                      low_res_factor: int = 4):
    """fn(generator, x1) -> the condition of a batch: the image with a
    random patch at `pad_value` (inpaint), or its bilinear downsample by
    `low_res_factor` (superres; `generator` unused)."""
    h, w, _ = dim
    if task == "inpaint":
        lik = InPainting(patch_size=patch_size, pad_value=pad_value)

        def fn(generator, x1):
            return lik.sample(generator, x1)
    else:
        lh, lw = h // low_res_factor, w // low_res_factor

        def fn(generator, x1):
            del generator
            return resize_bilinear(x1, lh, lw)
    return fn


def make_loss_fn(matcher, condition_fn, task: str, weighted: bool,
                 pad_value: float):
    """loss(model, generator, x1): x0 ~ N(0, I), the condition, then
    mean((v(t, x_t, cond) - u_t)^2), weighted 10x where the condition is
    `pad_value` for inpainting with `weighted`. `x0`, `t`, `eps` and `cond`
    may be passed instead of drawn."""

    def loss_fn(model, generator, x1, x0=None, t=None, eps=None, cond=None):
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                             dtype=x1.dtype)
        if cond is None:
            cond = condition_fn(generator, x1)
        t, xt, ut = matcher.sample_location_and_conditional_flow(
            generator, x0, x1, t, eps)
        sq = (model(t, xt, cond, generator=generator) - ut) ** 2
        if weighted and task == "inpaint":
            return torch.mean((1.0 + 9.0 * (cond == pad_value).float()) * sq)
        return torch.mean(sq)

    return loss_fn


def make_conditional_sampler(method: str = "dopri5", num_steps: int = 100):
    """sample(model, generator, shape, cond, x0=None) -> (x1, nfe): the ODE
    of v(t, x; cond) from noise (or `x0`) to t=1 with the condition held
    fixed (utils_mnist.py:90-110); dopri5 at rtol = atol = 1e-5, the other
    integrators over `num_steps` fixed steps."""

    @torch.no_grad()
    def sample(model, generator, shape, cond, x0=None):
        if x0 is None:
            x0 = torch.randn(shape, generator=generator, device=cond.device)

        def v(t, x):
            return model(t, x, cond)

        if method == "dopri5":
            return odeint(v, x0, method="dopri5", rtol=1e-5, atol=1e-5)
        return odeint(v, x0, method=method, num_steps=num_steps)

    return sample


def evaluate(model, test_ds, condition_fn, sampler, batch_size: int,
             num_batches: int, seed: int = 0):
    """(MSE/PSNR/SSIM/NFE means over up to `num_batches` test batches, the
    first batch's (samples, images) on the host) (train_mnist_hy.py:
    181-205). `model` in eval mode; conditions and noise from a generator
    seeded with `seed`."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    rows = []
    first = None
    for b in range(num_batches):
        imgs = test_ds.images[b * batch_size:(b + 1) * batch_size]
        if len(imgs) < batch_size:
            break
        imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
        cond = condition_fn(generator, imgs)
        x1, nfe = sampler(model, generator, tuple(imgs.shape), cond)
        x1 = x1.clamp(-1, 1)
        rows.append({
            "mse": float(mse(x1, imgs).mean()),
            "psnr": float(psnr(x1, imgs).mean()),
            "ssim": float(ssim(x1, imgs).mean()),
            "nfe": int(nfe),
        })
        if first is None:
            first = (x1.cpu().numpy(), imgs.cpu().numpy())
    if not rows:
        # e.g. an eval batch larger than the test split (synthetic256 has
        # 64 test images): say so instead of failing the training run
        print(f"[evaluate] WARNING: no eval batch of size {batch_size} "
              f"fits the {len(test_ds)}-image test split; skipping eval")
        return {"num_batches": 0}, None
    out = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    out["num_batches"] = len(rows)
    return out, first


def main(argv=None) -> dict:
    """Train, then evaluate; returns the final results, the train state and
    the output directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="inpaint",
                   choices=["inpaint", "superres"])
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "flowers", "celeba", "synthetic256"])
    p.add_argument("--model", default="icfm",
                   choices=["icfm", "otcfm", "fm", "si"])
    p.add_argument("--output_dir", default="results_cfm")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=20000)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--patch_size", type=int, default=0,
                   help="0 -> dataset default (14 mnist / 20 else)")
    p.add_argument("--pad_value", type=float, default=-2.0)
    p.add_argument("--low_res_factor", type=int, default=4)
    p.add_argument("--weighted_loss", action="store_true",
                   help="10x loss weight inside the patch (train_mnist2)")
    p.add_argument("--eval_method", default="dopri5",
                   choices=["dopri5", "euler", "heun", "midpoint", "rk4"])
    p.add_argument("--eval_every_div", type=int, default=10,
                   help="eval every num_steps/div steps (0: only the final "
                        "eval)")
    p.add_argument("--eval_batches", type=int, default=2)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_root", default="data")
    p.add_argument("--attention_impl", default="auto",
                   choices=sorted(ATTENTION_IMPLS),
                   help="xla: dense einsums; pallas: the flash kernels; "
                        "auto: flash at 1024 tokens or more")
    p.add_argument("--model_axis", type=int, default=1,
                   help="mesh model-axis size; >1 shards params over it "
                        "(tensor parallelism)")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="ring attention over the model axis (token-sharded "
                        "sequence parallelism)")
    p.add_argument("--num_channels", type=int, default=0,
                   help="0 -> dataset default (32 mnist / 128 else)")
    p.add_argument("--eval_ode_steps", type=int, default=100,
                   help="fixed steps for non-dopri5 eval integrators")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions "
                        "of the kernels)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device=device)

    patch = args.patch_size or (14 if args.dataset == "mnist" else 20)
    savedir = os.path.join(args.output_dir,
                           f"{args.dataset}_{args.task}_{args.model}")
    os.makedirs(savedir, exist_ok=True)
    writer = LocalWriter(savedir)
    writer.log_hparams(vars(args))

    mesh = make_mesh(model=args.model_axis)
    train_ds = get_dataset(args.dataset)(args.data_root, train=True)
    test_ds = get_dataset(args.dataset)(args.data_root, train=False)
    torch.manual_seed(args.seed)  # the model's own initialisation
    model, dim = build(args.task, args.dataset,
                       ATTENTION_IMPLS[args.attention_impl],
                       args.num_channels, device,
                       sp_mesh=mesh if args.sequence_parallel else None)
    matcher = get_matcher(args.model, sigma=0.0,
                          **({"method": "sinkhorn"}
                             if args.model == "otcfm" else {}))
    condition_fn = make_condition_fn(args.task, dim, patch, args.pad_value,
                                     args.low_res_factor)
    n_params = sum(x.numel() for x in model.parameters())
    print(f"[train_cfm_conditional] {args.task}/{args.dataset}/{args.model}"
          f": {n_params / 1e6:.2f}M params, device={device}")

    optimizer = make_optimizer(model.parameters(), args.lr,
                               warmup=args.warmup, grad_clip=args.grad_clip,
                               mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(model, optimizer, generator)
    train_step = make_train_step(
        make_loss_fn(matcher, condition_fn, args.task, args.weighted_loss,
                     args.pad_value), ema_decay=args.ema_decay)
    sampler = make_conditional_sampler(args.eval_method, args.eval_ode_steps)
    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"), maximum=3)
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    results_per_step = []

    def run_eval(step, state, **kw):
        set_params(ema_model, state.ema.params)
        results, first = evaluate(ema_model, test_ds, condition_fn, sampler,
                                  args.eval_batch_size, args.eval_batches,
                                  seed=args.seed)
        results_per_step.append({"step": step, "evaluation_results": results})
        with open(os.path.join(savedir, "results_per_step.json"), "w") as f:
            json.dump(results_per_step, f, indent=2)
        writer.write_scalars(step, {f"eval/{k}": v for k, v in
                                    results.items()})
        if first is not None:
            writer.write_images(step, {"generated": first[0][:16],
                                       "ground_truth": first[1][:16]})
        ckpt.save(step, {"params": state.params, "ema": state.ema.params,
                         "step": step})
        return results

    callbacks = [
        PeriodicCallback(callback_fn=lambda step, metrics, **kw:
                         writer.write_scalars(step, metrics),
                         every_steps=50),
    ]
    if args.eval_every_div > 0:
        every = max(args.num_steps // args.eval_every_div, 1)
        callbacks.append(PeriodicCallback(callback_fn=run_eval,
                                          every_steps=every))
    batches = infinite_batches(train_ds, args.batch_size, seed=args.seed)
    state = Trainer(train_step, state, batches, mesh=mesh,
                    callbacks=callbacks,
                    tensor_parallel=args.model_axis > 1).fit(args.num_steps)

    final = run_eval(state.step, state)
    with open(os.path.join(savedir, "results.json"), "w") as f:
        json.dump(final, f, indent=2)
    print("[train_cfm_conditional] final:", json.dumps(final))
    writer.flush()
    return {"results": final, "state": state, "output_dir": savedir,
            "n_params": n_params}


if __name__ == "__main__":
    main()
