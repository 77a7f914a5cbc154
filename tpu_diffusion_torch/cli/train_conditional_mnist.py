"""Class-conditional generation: conditional CFM, guided OT-CFM and SF2M, in
PyTorch.

Counterpart of `tpu_diffusion/cli/train_conditional_mnist.py` (the
reference's `conditional_mnist.ipynb`), with its flags plus `--device`:

    python -m tpu_diffusion_torch.cli.train_conditional_mnist --variant sf2m

  * `--variant cfm`: class-conditional I-CFM, v(t, x, y) with the labels as
    a class embedding (notebook cells 2-5);
  * `--variant otcfm`: OT-CFM through
    `guided_sample_location_and_conditional_flow`, the sinkhorn plan
    permuting the labels with x1 (cells 6-8);
  * `--variant sf2m`: Schrödinger-bridge flow matching with two heads,
    velocity and score, the score loss mean((lambda_t s + eps)^2), sampled
    by the generative SDE dx = [v + sigma^2/2 score] dt + sigma dW
    (cells 9-11).

The model is an `nn.ModuleDict` of `UNetModelWrapper`s ({"flow"}, plus
"score" for sf2m), the JAX package's parameter tree. Every num_steps / 5
steps (`--save_every`) and at the end, the EMA model draws a grid of
`--sample_grid_per_class` images per class (Euler over `--sample_steps`
steps, or the SDE for sf2m), writes it, appends its nearest-template class
consistency to `class_trend.json` and saves a checkpoint {params, ema,
step} under `<output_dir>/<variant>/ckpt/`. Runs on the CUDA card unless
`--device cpu`.
Under COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID each process is
one rank of a data-parallel mesh (`parallel/`).
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch
from torch import nn

from tpu_diffusion_torch.cli.main import set_params
from tpu_diffusion_torch.data.registry import get_dataset
from tpu_diffusion_torch.losses.cfm import (
    SchrodingerBridgeConditionalFlowMatcher, cfm_loss, get_matcher, host_read)
from tpu_diffusion_torch.models.unet import UNetModelWrapper, resolve_device
from tpu_diffusion_torch.parallel.distributed import initialize_distributed
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.sampling.ancestral import NoiseFn, randn_noise
from tpu_diffusion_torch.sampling.graph import GraphCache
from tpu_diffusion_torch.sampling.ode import odeint
from tpu_diffusion_torch.train.actions import PeriodicCallback
from tpu_diffusion_torch.train.checkpoint import CheckpointManager
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step, step_seed)
from tpu_diffusion_torch.train.writers import LocalWriter

NUM_CLASSES = 10


def build_model(num_channels: int = 32, image_size: int = 28,
                channels: int = 1, device="cuda") -> UNetModelWrapper:
    return UNetModelWrapper(
        dim=(image_size, image_size, channels), num_channels=num_channels,
        num_heads=4, attention_resolutions="14" if image_size == 28
        else "16", num_classes=NUM_CLASSES, device=device)


def labeled_batches(ds, batch_size: int, seed: int = 0):
    """Shuffled epochs of {"x": images, "y": labels} forever."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = perm[s:s + batch_size]
            yield {"x": ds.images[idx], "y": ds.labels[idx]}


def class_consistency(gen: np.ndarray, labels: np.ndarray,
                      templates: np.ndarray) -> dict:
    """Nearest-template classification of generated digits.

    `templates` [K,H,W,C] are per-class mean images of the training set;
    a generated image is "consistent" when its nearest template (MSE) is
    its conditioning class. Measurable without real MNIST: the synthetic
    fallback gives each class a distinct blob position + texture frequency
    (data/registry.py:synthetic_images), so the per-class means separate.
    Returns overall accuracy, per-class accuracy, and the mean PSNR of
    each image against its OWN class template."""
    d = ((gen[:, None] - templates[None]) ** 2).mean(axis=(2, 3, 4))  # [N,K]
    pred = d.argmin(axis=1)
    own = d[np.arange(len(gen)), labels]
    acc_per_class = [float((pred[labels == k] == k).mean())
                     if (labels == k).any() else None
                     for k in range(len(templates))]
    return {
        "accuracy": float((pred == labels).mean()),
        "per_class_accuracy": acc_per_class,
        "psnr_to_own_template": float(np.mean(
            10.0 * np.log10(4.0 / np.maximum(own, 1e-10)))),
    }


def class_templates(ds) -> np.ndarray:
    return np.stack([ds.images[ds.labels == k].mean(axis=0)
                     for k in range(NUM_CLASSES)])


@torch.no_grad()
def sf2m_generative_sde(flow_apply, score_apply, generator, x0, y,
                        sigma: float, num_steps: int = 100, *,
                        noise: NoiseFn | None = None) -> torch.Tensor:
    """dx = [v + sigma^2/2 score] dt + sigma dW, t: 0 -> 1 by
    Euler-Maruyama with no noise on the last step; clipped to [-1, 1].
    Step k's noise is `noise(x, "sde", k)` (default: `torch.randn` on
    `generator`)."""
    draw = noise or randn_noise(generator)
    ts = torch.linspace(0.0, 1.0, num_steps + 1)
    dts = ts[1:] - ts[:-1]
    ts, sqrt_dts, dts = ts.tolist(), torch.sqrt(dts).tolist(), dts.tolist()
    x = x0
    for k in range(num_steps):
        t = torch.full((x.shape[0],), ts[k], device=x.device)
        drift = flow_apply(t, x, y) + 0.5 * sigma**2 * score_apply(t, x, y)
        x = x + dts[k] * drift
        if k < num_steps - 1:
            x = x + sigma * sqrt_dts[k] * draw(x, "sde", k)
    return x.clamp(-1, 1)


def make_loss_fn(matcher, sf2m: bool):
    """loss(model, generator, batch) over a {"flow"[, "score"]} ModuleDict
    and a {"x", "y"} batch. sf2m: the flow loss plus
    mean((lambda_t * s + eps)^2); else the CFM loss of the label-guided
    path. `x0`, `t` and `eps` may be passed instead of drawn."""

    def loss_fn(model, generator, batch, x0=None, t=None, eps=None):
        x1, y1 = batch["x"], batch["y"]
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                             dtype=x1.dtype)
        if sf2m:
            t, xt, ut, eps = \
                matcher.sample_location_and_conditional_flow_with_eps(
                    generator, x0, x1, t, eps)
            lam = matcher.compute_lambda(t)
            vt = model["flow"](t, xt, y1, generator=generator)
            st = model["score"](t, xt, y1, generator=generator)
            return cfm_loss(vt, ut) + torch.mean(
                (lam.reshape(-1, 1, 1, 1) * st + eps) ** 2)
        t, xt, ut, y1p = matcher.guided_sample_location_and_conditional_flow(
            generator, x0, x1, y1, t, eps)
        return cfm_loss(model["flow"](t, xt, y1p, generator=generator), ut)

    loss_fn.eager_reason = host_read(matcher)
    return loss_fn


def main(argv=None) -> dict:
    """Train; returns the last grid (on the CPU), the class-consistency
    trend, the train state and the output directory."""
    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="cfm",
                   choices=["cfm", "otcfm", "sf2m"])
    p.add_argument("--output_dir", default="results_conditional")
    p.add_argument("--num_channel", type=int, default=32)
    p.add_argument("--num_steps", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--sigma", type=float, default=0.1,
                   help="path noise (sf2m bridge sigma)")
    p.add_argument("--sample_steps", type=int, default=100)
    p.add_argument("--sample_grid_per_class", type=int, default=8)
    p.add_argument("--save_every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_root", default="data")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device=device)
    mesh = make_mesh()  # every rank on "data"

    savedir = os.path.join(args.output_dir, args.variant)
    os.makedirs(savedir, exist_ok=True)
    writer = LocalWriter(savedir)
    writer.log_hparams(vars(args))

    ds = get_dataset("mnist")(args.data_root, train=True)
    sf2m = args.variant == "sf2m"
    torch.manual_seed(args.seed)  # the models' own initialisation
    model = nn.ModuleDict(
        {head: build_model(args.num_channel, device=device)
         for head in (("flow", "score") if sf2m else ("flow",))})
    if args.variant == "cfm":
        matcher = get_matcher("icfm", sigma=args.sigma)
    elif args.variant == "otcfm":
        matcher = get_matcher("otcfm", sigma=args.sigma, method="sinkhorn")
    else:
        matcher = SchrodingerBridgeConditionalFlowMatcher(sigma=args.sigma)

    optimizer = make_optimizer(model.parameters(), args.lr,
                               warmup=args.warmup, grad_clip=1.0, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(model, optimizer, generator)
    train_step = make_train_step(make_loss_fn(matcher, sf2m),
                                 ema_decay=args.ema_decay)
    ckpt = CheckpointManager(os.path.join(savedir, "ckpt"), maximum=2)
    templates = class_templates(ds)
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    last: dict = {"output_dir": savedir, "class_trend": []}
    n = args.sample_grid_per_class
    y = torch.arange(NUM_CLASSES, device=device).repeat_interleave(n)
    # the Euler grid's chain over one field, captured again after each
    # set_params
    grid_graphs = GraphCache(ema_model)

    def grid_field(t, x):
        return ema_model["flow"](t, x, y)

    @torch.no_grad()
    def sample_grid(step, state, **kw):
        set_params(ema_model, state.ema.params)
        # the grid's noise is a function of (seed, step)
        gen = torch.Generator(device=device).manual_seed(
            step_seed(args.seed, step))
        x0 = torch.randn((NUM_CLASSES * n, 28, 28, 1), generator=gen,
                         device=device)
        if sf2m:
            imgs = sf2m_generative_sde(ema_model["flow"], ema_model["score"],
                                       gen, x0, y, args.sigma,
                                       args.sample_steps)
        else:
            imgs, _ = odeint(grid_field, x0, method="euler",
                             num_steps=args.sample_steps, graphs=grid_graphs)
            imgs = imgs.clamp(-1, 1)
        imgs = imgs.cpu()
        imgs_np = imgs.numpy()
        writer.write_images(step, {f"{args.variant}_classes": imgs_np})
        # per-class consistency trend (nearest-template classification)
        row = {"step": int(step),
               **class_consistency(imgs_np, y.cpu().numpy(), templates)}
        last["class_trend"].append(row)
        with open(os.path.join(savedir, "class_trend.json"), "w") as f:
            json.dump(last["class_trend"], f, indent=2)
        print(f"[train_conditional_mnist] step {step} class-consistency "
              f"acc={row['accuracy']:.3f} "
              f"psnr_own={row['psnr_to_own_template']:.2f}", flush=True)
        ckpt.save(step, {"params": state.params, "ema": state.ema.params,
                         "step": step})
        last.update(grid=imgs, step=step)

    every = args.save_every or max(args.num_steps // 5, 1)
    callbacks = [
        PeriodicCallback(callback_fn=lambda step, metrics, **kw:
                         writer.write_scalars(step, metrics),
                         every_steps=50),
        PeriodicCallback(callback_fn=sample_grid, every_steps=every),
    ]
    trainer = Trainer(train_step, state,
                      labeled_batches(ds, args.batch_size, args.seed),
                      mesh=mesh, callbacks=callbacks)
    print(f"[train_conditional_mnist] {trainer.route()}")
    state = trainer.fit(args.num_steps)
    sample_grid(state.step, state)
    writer.flush()
    print(f"[train_conditional_mnist] {args.variant} done at "
          f"step {state.step}")
    last["state"] = state
    return last


if __name__ == "__main__":
    main()
