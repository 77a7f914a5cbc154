"""CIFAR-10 conditional-flow-matching training, in PyTorch.

Counterpart of `tpu_diffusion/cli/train_cifar10.py`, with its flags plus
`--device`:

    python -m tpu_diffusion_torch.cli.train_cifar10 --model otcfm \\
        --lr 2e-4 --ema_decay 0.9999 --batch_size 128 --total_steps 400001 \\
        --warmup 5000 --save_step 20000

Matcher selection {otcfm, icfm, fm, si} as the reference's
train_cifar10.py:126-137; the recipe is Adam + linear warmup + global-norm
clip 1.0 + EMA 0.9999, on the UNetModelWrapper CIFAR config (128 channels,
(1,2,2,2), attention at 16x16 with 4 heads, dropout 0.1, bf16 compute with
fp32 parameters). `--model otcfm` pairs each batch with its noise by exact
OT on the host, on a prefetch thread (`losses/cfm.py:host_ot_pairs`);
`--ot_method sinkhorn` pairs inside the step on the device. Batches are
flipped at random. Dropout masks, the unpaired noise, t and the path noise
come from the trainer's generator on the device. Every `--save_step` steps
and at the end: a checkpoint `{params, ema, step}` under
`<output_dir>/<model>/ckpt/` and a grid of EMA samples by Euler over
`--sample_steps` steps. Runs on the CUDA card unless `--device cpu`.
Under COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID each process is
one rank of a data-parallel mesh (`parallel/`).
"""

from __future__ import annotations

import argparse
import copy
import os

import torch

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.data.registry import get_dataset, infinite_batches
from tpu_diffusion_torch.losses.cfm import cfm_loss, get_matcher, host_ot_pairs
from tpu_diffusion_torch.models.unet import UNetModelWrapper, resolve_device
from tpu_diffusion_torch.parallel.distributed import initialize_distributed
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.sampling.ode import odeint
from tpu_diffusion_torch.train.actions import PeriodicCallback
from tpu_diffusion_torch.train.checkpoint import CheckpointManager
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step)
from tpu_diffusion_torch.train.writers import LocalWriter

# the JAX package's --attention_impl values, in the port's names
ATTENTION_IMPLS = {"xla": "dense", "pallas": "flash", "auto": "auto"}


def build_model(image_size: int = 32, num_channels: int = 128,
                channels: int = 3, attention_impl: str = "auto",
                device="cuda") -> UNetModelWrapper:
    """The reference CIFAR UNet config (train_cifar10.py:92-103)."""
    return UNetModelWrapper(
        dim=(image_size, image_size, channels), num_channels=num_channels,
        channel_mult=(1, 2, 2, 2), num_heads=4,
        attention_resolutions="16", dropout=0.1,
        attention_impl=attention_impl, device=device)


def make_cfm_loss_fn(matcher, paired: bool = False):
    """loss(model, generator, batch): t, xt, ut from the matcher, then
    mean((v(t, xt) - ut)^2) (train_cifar10.py:145-149).

    `paired=False`: batch is x1; x0 ~ N(0, I) is drawn in the step.
    `paired=True`: batch is an (x0, x1) tuple already coupled on the host
    (`losses.cfm.host_ot_pairs`). `t` and `eps` may be passed instead of
    drawn."""

    def loss_fn(model, generator, batch, t=None, eps=None):
        if paired:
            x0, x1 = batch
        else:
            x1 = batch
            x0 = torch.randn(x1.shape, generator=generator,
                             device=x1.device, dtype=x1.dtype)
        t, xt, ut = matcher.sample_location_and_conditional_flow(
            generator, x0, x1, t, eps)
        return cfm_loss(model(t, xt, generator=generator), ut)

    return loss_fn


@torch.no_grad()
def generate_samples(model, generator: torch.Generator, n: int = 64,
                     image_size: int = 32, channels: int = 3,
                     steps: int = 100, method: str = "euler"):
    """(images clipped to [-1, 1], NFE): the ODE from noise over a fixed
    grid (utils_cifar.py:13-41). `model` in eval mode."""
    device = next(model.parameters()).device
    x0 = torch.randn((n, image_size, image_size, channels),
                     generator=generator, device=device)
    x1, nfe = odeint(model, x0, method=method, num_steps=steps)
    return x1.clamp(-1, 1), nfe


def main(argv=None) -> dict:
    """Train; returns the last sample grid (on the CPU), its NFE and step,
    and the output directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="otcfm",
                   choices=["otcfm", "icfm", "fm", "si"],
                   help="flow matcher (train_cifar10.py:24-27)")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--num_channel", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--total_steps", type=int, default=400001)
    p.add_argument("--warmup", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--save_step", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_root", default="data")
    p.add_argument("--ot_method", default="exact",
                   choices=["exact", "sinkhorn"],
                   help="minibatch-OT solver for otcfm: exact pairs on the "
                        "host between steps (reference protocol); sinkhorn "
                        "is entropic OT on the device")
    p.add_argument("--attention_impl", default="auto",
                   choices=sorted(ATTENTION_IMPLS),
                   help="xla: dense einsums; pallas: the flash kernels; "
                        "auto: flash at 1024 tokens or more")
    p.add_argument("--sample_grid", type=int, default=64,
                   help="images per periodic sample grid")
    p.add_argument("--sample_steps", type=int, default=100,
                   help="fixed Euler steps for periodic sampling")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions "
                        "of the kernels)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device=device)
    mesh = make_mesh()  # every rank on "data"

    savedir = os.path.join(args.output_dir, args.model)
    os.makedirs(savedir, exist_ok=True)
    writer = LocalWriter(savedir)
    writer.log_hparams(vars(args))

    ds = get_dataset("cifar10")(args.data_root, train=True)
    batches = infinite_batches(ds, args.batch_size, seed=args.seed,
                               flip=True)  # RandomHorizontalFlip (:73)
    torch.manual_seed(args.seed)  # the model's own initialisation
    model = build_model(num_channels=args.num_channel,
                        attention_impl=ATTENTION_IMPLS[args.attention_impl],
                        device=device)
    # exact OT pairs on the host between steps (the reference's POT plan is
    # host-side too, train_cifar10.py:147); after pairing, I-CFM
    paired = args.model == "otcfm" and args.ot_method == "exact"
    if paired:
        batches = host_ot_pairs(batches, seed=args.seed)
        matcher = get_matcher("icfm", sigma=0.0)
    elif args.model == "otcfm":
        matcher = get_matcher("otcfm", sigma=0.0, method=args.ot_method)
    else:
        matcher = get_matcher(args.model, sigma=0.0)

    n_params = sum(x.numel() for x in model.parameters())
    print(f"[train_cifar10] {args.model}: {n_params / 1e6:.2f}M params, "
          f"device={device}")
    optimizer = make_optimizer(model.parameters(), args.lr,
                               warmup=args.warmup, grad_clip=args.grad_clip,
                               schedule="warmup", mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(model, optimizer, generator)
    train_step = make_train_step(make_cfm_loss_fn(matcher, paired=paired),
                                 ema_decay=args.ema_decay)
    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"), maximum=3)
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    last: dict = {"output_dir": savedir}

    def save_and_sample(step, state, **kw):
        ckpt.save(step, {"params": state.params, "ema": state.ema.params,
                         "step": step})
        set_params(ema_model, state.ema.params)
        # the grid's noise is a function of (seed, step)
        gen = torch.Generator(device=device).manual_seed(
            (args.seed << 32) + step)
        grid, nfe = generate_samples(ema_model, gen, n=args.sample_grid,
                                     steps=args.sample_steps)
        grid = grid.cpu()
        writer.write_images(step, {f"{args.model}_generated": grid.numpy()})
        last.update(grid=grid, nfe=nfe, step=step)

    callbacks = [
        PeriodicCallback(callback_fn=lambda step, metrics, **kw:
                         writer.write_scalars(step, metrics),
                         every_steps=100),
        PeriodicCallback(callback_fn=save_and_sample,
                         every_steps=args.save_step),
    ]
    state = Trainer(train_step, state, batches, mesh=mesh,
                    callbacks=callbacks).fit(args.total_steps)
    save_and_sample(state.step, state)
    writer.flush()
    return last


if __name__ == "__main__":
    main()
