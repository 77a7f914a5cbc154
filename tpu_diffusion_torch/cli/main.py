"""Amortised-diffusion experiment runner, evaluation mode, in PyTorch.

Counterpart of `tpu_diffusion/cli/main.py`:

    python -m tpu_diffusion_torch.cli.main \\
        --config flowers,inpainting,amortized --mode eval \\
        --override testing.lpips=false

Builds the UNet, the DDPM process, the likelihood and the conditioning from
the `<dataset>,<likelihood>,<conditioning>` spec, samples conditionally over
`testing.num_test` test images (1000 ancestral steps by default; the
encoder-reuse sampler for amortized conditioning), and writes MSE/PSNR/SSIM
statistics to `results.json` under the versioned experiment directory
`logs/<ds>_<cond>_<lik>/version_XX`. Runs on the CUDA card unless
`--device cpu`. Not ported yet, and raising when asked for: training
(`--mode train|all`, ROADMAP A5), checkpoint loading (ROADMAP A9), LPIPS
and FID (ROADMAP A6), and the mesh (ROADMAP A10). With no checkpoint it
evaluates the model's random initialisation, as the JAX package does, and
says so.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from tpu_diffusion_torch.conditioning.guidance import (Amortized,
                                                       get_conditioning)
from tpu_diffusion_torch.conditioning.likelihoods import get_likelihood
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.data.registry import get_dataset
from tpu_diffusion_torch.eval.metrics import eval_statistics
from tpu_diffusion_torch.losses.ddpm import get_loss_function
from tpu_diffusion_torch.models.unet import create_model, resolve_device
from tpu_diffusion_torch.sampling.ancestral import (
    make_cached_amortized_sampler, make_conditional_sampler,
    make_prior_sampler)
from tpu_diffusion_torch.utils.config import apply_overrides, get_config


def experiment_dir(base: str, spec: str) -> str:
    """logs/<ds>_<cond>_<lik>/version_XX (main.py:80-92)."""
    ds, lik, cond = (s.strip() for s in spec.split(","))
    root = os.path.join(base, f"{ds}_{cond}_{lik}")
    os.makedirs(root, exist_ok=True)
    existing = [int(d.split("_")[1]) for d in os.listdir(root)
                if d.startswith("version_")]
    version = max(existing, default=-1) + 1
    path = os.path.join(root, f"version_{version:02d}")
    os.makedirs(path)
    return path


def build(config, device="cuda") -> dict:
    """Instantiate model/process/likelihood/conditioning; returns a dict of
    parts (mirrors main.py:100-142)."""
    dsc, net_c = config.dataset, config.network
    if net_c.get("sequence_parallel", False) or config.mesh.model_axis > 1:
        raise NotImplementedError(
            "network.sequence_parallel / mesh.model_axis > 1: the mesh is "
            "not ported yet (ROADMAP A10)")
    likelihood = None
    if config.likelihood.name != "none":
        likelihood = get_likelihood(config.likelihood.name).from_configdict(
            config.likelihood)
    conditioning = None
    if config.conditioning.name != "none":
        conditioning = get_conditioning(
            config.conditioning.name).from_configdict(config.conditioning)

    amortized = config.conditioning.name == "amortized"
    in_channels = dsc.num_channels * (2 if amortized else 1)
    model = create_model(
        image_size=dsc.image_size, num_channels=net_c.num_channels,
        num_res_blocks=net_c.num_res_blocks, in_channels=in_channels,
        out_channels=dsc.num_channels, channel_mult=net_c.channel_mult,
        num_heads=net_c.num_heads, num_head_channels=net_c.num_head_channels,
        attention_resolutions=net_c.attention_resolutions,
        dropout=net_c.dropout, use_scale_shift_norm=net_c.use_scale_shift_norm,
        attention_impl=net_c.attention_impl,
        dtype=torch.bfloat16 if net_c.dtype == "bfloat16" else torch.float32,
        device=device)
    ddpm = DDPM.create(config.diffusion.num_steps)
    return dict(model=model, ddpm=ddpm, likelihood=likelihood,
                conditioning=conditioning, in_channels=in_channels)


def make_samplers(config, parts):
    """The samplers of the JAX `make_losses_and_samplers`:
    `cond_sample(model, xT, condition, generator=None)` and
    `prior_sample(model, xT, generator=None)`. Amortized conditioning with
    `testing.encoder_reuse` > 1 takes the encoder-reuse sampler."""
    ddpm = parts["ddpm"]
    cond, lik = parts["conditioning"], parts["likelihood"]
    reuse = int(config.testing.get("encoder_reuse", 1))

    def cond_sample(model, xT, condition, generator=None):
        if reuse > 1 and isinstance(cond, Amortized):
            # the i -> t adapter of losses.ddpm.make_eps_model
            def encode_fn(xi, i):
                return model(xi, i.float() / ddpm.num_steps, mode="encode")

            def decode_fn(xi, i, cache):
                return model(xi, i.float() / ddpm.num_steps, mode="decode",
                             cache=cache)

            sampler = make_cached_amortized_sampler(
                encode_fn, decode_fn, ddpm, cond, lik, encoder_reuse=reuse)
        else:
            _, eps = get_loss_function(model, ddpm, cond, lik)
            sampler = make_conditional_sampler(eps, ddpm, cond, lik)
        return sampler(xT, condition, generator)

    def prior_sample(model, xT, generator=None):
        _, eps = get_loss_function(model, ddpm, cond, lik)
        return make_prior_sampler(eps, ddpm, cond, lik)(xT, generator)

    return cond_sample, prior_sample


def _check_metrics(config) -> None:
    if config.testing.lpips or config.testing.fid:
        raise NotImplementedError(
            "testing.lpips / testing.fid: LPIPS and FID are not ported yet "
            "(ROADMAP A6); pass --override testing.lpips=false")


def run_eval(config, parts, model, logdir: str, cond_sample=None) -> dict:
    """Conditional sampling over the test set, MSE/PSNR/SSIM statistics per
    batch averaged over the batches, and results.json (main.py:261-314).
    The condition, xT and the chain's noise come from one generator on the
    model's device, seeded with `testing.seed`."""
    dsc = config.dataset
    lik = parts["likelihood"]
    if lik is None:
        # a 'none'-likelihood config has nothing to condition on
        results = {"skipped": "likelihood 'none': no conditional eval"}
        with open(os.path.join(logdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        return results
    _check_metrics(config)
    if cond_sample is None:
        cond_sample, _ = make_samplers(config, parts)
    device = next(model.parameters()).device
    test = get_dataset(dsc.name)(dsc.root, train=False)
    bs = config.testing.batch_size
    num_batches = max(config.testing.num_test // bs, 1)
    gen = torch.Generator(device=device).manual_seed(config.testing.seed)
    stats = []
    n_eval = 0
    for b in range(num_batches):
        imgs = test.images[b * bs:(b + 1) * bs]
        if len(imgs) < bs:
            break
        imgs = torch.from_numpy(imgs).to(device)
        condition = lik.sample(gen, imgs)
        xT = torch.randn(imgs.shape, generator=gen, device=device)
        x0 = cond_sample(model, xT, condition, gen)
        stats.append({k: float(v) for k, v in
                      eval_statistics(x0, imgs).items()})
        n_eval += len(imgs)
    results = {k: float(np.mean([s[k] for s in stats]))
               for k in (stats[0] if stats else {})}
    results["num_images"] = n_eval
    with open(os.path.join(logdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="mnist,inpainting,amortized",
                   help="<dataset>,<likelihood>,<conditioning>")
    p.add_argument("--mode", default="all",
                   choices=["train", "eval", "all"])
    p.add_argument("--override", action="append", default=[],
                   help="dotted config overrides, e.g. testing.num_test=32")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch versions "
                        "of the kernels)")
    args = p.parse_args(argv)
    if args.mode != "eval":
        raise NotImplementedError(
            f"--mode {args.mode}: training is not ported yet (ROADMAP A5, "
            f"the training slice); the port runs --mode eval")

    config = get_config(args.config)
    apply_overrides(config, args.override)
    _check_metrics(config)
    device = resolve_device(args.device)
    logdir = args.workdir or experiment_dir(config.logdir, args.config)
    os.makedirs(logdir, exist_ok=True)

    torch.manual_seed(config.training.seed)  # the model's random init
    parts = build(config, device)
    model = parts["model"].eval().requires_grad_(False)
    model_path = config.network.get("model_path", "")
    if model_path:
        if os.path.exists(model_path):
            raise NotImplementedError(
                f"network.model_path={model_path!r}: loading checkpoints is "
                f"not ported yet (ROADMAP A9)")
        print(f"[main] no pretrained weights at {model_path!r}; training "
              "from scratch")
    ckpt_dir = os.path.join(logdir, "ckpt")
    if os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        raise NotImplementedError(
            f"{ckpt_dir}: loading checkpoints is not ported yet (ROADMAP A9)")
    n_params = sum(x.numel() for x in model.parameters())
    print(f"[main] {args.config} -> {logdir}; params={n_params / 1e6:.2f}M; "
          f"device={device}")
    # no checkpoint in this workdir: the JAX package's warning
    print("[main] WARNING: --mode eval found no checkpoint under this "
          "workdir; evaluating RANDOM-INIT params (pass --workdir pointing "
          "at a trained run)")
    results = run_eval(config, parts, model, logdir)
    print("[main] eval:", json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
