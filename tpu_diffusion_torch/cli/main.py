"""Amortised-diffusion experiment runner, in PyTorch.

Counterpart of `tpu_diffusion/cli/main.py`:

    python -m tpu_diffusion_torch.cli.main \\
        --config flowers,inpainting,amortized --mode all \\
        --override testing.lpips=false

Builds the UNet, the DDPM process, the likelihood and the conditioning from
the `<dataset>,<likelihood>,<conditioning>` spec. `--mode train` trains the
DDPM (or amortized) objective with Adam, global-norm clipping and an EMA of
the parameters, with the JAX package's callback cadence (scalars every 10
steps; checkpoint, sample grid and periodic eval every num_steps / 10) and
a final checkpoint under `<workdir>/ckpt/`. `--mode eval` restores the EMA
parameters from there and samples conditionally over `testing.num_test`
test images (1000 ancestral steps by default; the encoder-reuse sampler for
amortized conditioning), writing MSE/PSNR/SSIM statistics and, with
`testing.lpips` (the default), LPIPS per eval batch to `results.json` under
the versioned experiment directory `logs/<ds>_<cond>_<lik>/version_XX`;
`testing.fid` adds the FID of the eval samples against the train set's
features (`testing.fid_features`), with the caveat fields of
`eval/fid.py:fid_caveat`. The default LPIPS and FID features are random
(fixed torch seeds): self-consistent only. `--mode all` does both. Runs on
the CUDA card unless `--device cpu`. `mesh.model_axis` sets the mesh's
"model" axis (the parameters sharded over it when > 1) and
`network.sequence_parallel` hands the mesh to the UNet's attention (ring
attention over "model"); under COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID each process is one rank of the mesh. With no checkpoint,
`--mode eval` evaluates the model's random initialisation, as the JAX
package does, and says so.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Optional

import numpy as np
import torch

from tpu_diffusion_torch.conditioning.guidance import (Amortized,
                                                       get_conditioning)
from tpu_diffusion_torch.conditioning.likelihoods import get_likelihood
from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.data.registry import (epoch_batches, get_dataset,
                                               infinite_batches)
from tpu_diffusion_torch.eval.fid import (compute_statistics, fid_caveat,
                                          frechet_distance, make_feature_fn)
from tpu_diffusion_torch.eval.lpips import PerceptualDistance
from tpu_diffusion_torch.eval.metrics import eval_statistics
from tpu_diffusion_torch.losses.ddpm import get_loss_function
from tpu_diffusion_torch.models.unet import create_model, resolve_device
from tpu_diffusion_torch.parallel.distributed import initialize_distributed
from tpu_diffusion_torch.parallel.mesh import make_mesh
from tpu_diffusion_torch.parallel.tp import full_tensor
from tpu_diffusion_torch.sampling.ancestral import (
    make_cached_amortized_sampler, make_conditional_sampler,
    make_prior_sampler)
from tpu_diffusion_torch.train.actions import PeriodicCallback
from tpu_diffusion_torch.train.checkpoint import (CheckpointManager,
                                                  load_matching_params,
                                                  load_pretrained)
from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                               make_optimizer,
                                               make_train_step)
from tpu_diffusion_torch.train.writers import (LocalWriter, MultiWriter,
                                               TensorBoardWriter)
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


def build(config, device="cuda", mesh=None) -> dict:
    """Instantiate model/process/likelihood/conditioning; returns a dict of
    parts (mirrors main.py:100-142). With `network.sequence_parallel` the
    UNet's attention takes `mesh`."""
    dsc, net_c = config.dataset, config.network
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
        device=device,
        sp_mesh=mesh if net_c.get("sequence_parallel", False) else None)
    ddpm = DDPM.create(config.diffusion.num_steps).to(device)
    return dict(model=model, ddpm=ddpm, likelihood=likelihood,
                conditioning=conditioning, in_channels=in_channels)


def init_state(config, parts, mesh=None):
    """(train state, tensors warm-started) for `parts["model"]` (already
    initialised from `training.seed`): a `network.model_path` warm start
    copies every shape-matching tensor of the newest checkpoint there (its
    EMA parameters when it has them), then Adam with the config's schedule
    (averaging the gradients over `mesh`'s "data" axis), the EMA, and the
    generator of the training draws on the model's device. The count (0 = none) lets --mode eval tell "evaluating warm-started
    pretrained weights" from "evaluating the random initialisation"."""
    warm_started = 0
    model = parts["model"]
    model_path = config.network.get("model_path", "")
    if model_path:
        loaded = load_pretrained(model_path)
        if loaded is None:
            print(f"[main] no pretrained weights at {model_path!r}; training "
                  "from scratch")
        else:
            src = loaded.get("ema", loaded.get("params", loaded))
            merged, n_copied, n_skipped = load_matching_params(
                dict(model.named_parameters()), src)
            set_params(model, merged)
            warm_started = n_copied
            print(f"[main] warm-start from {model_path!r}: {n_copied} "
                  f"tensors copied, {n_skipped} skipped")
    tr = config.training
    optimizer = make_optimizer(
        model.parameters(), tr.learning_rate, warmup=tr.warmup,
        grad_clip=tr.grad_clip, total_steps=max(tr.num_steps, 1),
        schedule=tr.lr_schedule, mesh=mesh)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(tr.seed)
    return TrainState.create(model, optimizer, generator), warm_started


@torch.no_grad()
def set_params(model, params) -> None:
    """Copy {name: tensor} into the model's parameters (the full tensor of
    a value sharded over "model")."""
    own = dict(model.named_parameters())
    for name, value in params.items():
        own[name].copy_(full_tensor(value))


def make_loss(parts):
    """loss(model, generator, batch): the training objective of the
    conditioning (amortized condition-dropout, or plain DDPM), with the
    dropout masks drawn from the same generator."""
    ddpm, cond, lik = parts["ddpm"], parts["conditioning"], parts["likelihood"]

    def loss_fn(model, generator, batch):
        def net(x, t):
            return model(x, t, generator=generator)
        return get_loss_function(net, ddpm, cond, lik)[0](generator, batch)

    return loss_fn


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


_LPIPS_CACHE: dict = {}
# real-set FID feature statistics, computed once per (dataset, features,
# size, device) and reused by every periodic eval in the run
_FID_REAL_CACHE: dict = {}


def _get_lpips(device) -> PerceptualDistance:
    """Memoized PerceptualDistance per device (its VGG pyramid is built
    once per run)."""
    key = str(device)
    if key not in _LPIPS_CACHE:
        _LPIPS_CACHE[key] = PerceptualDistance(device=device)
    return _LPIPS_CACHE[key]


def run_eval(config, parts, model, logdir: str, writer=None, step: int = 0,
             tag: str = "eval", cond_sample=None) -> dict:
    """Conditional sampling over the test set, MSE/PSNR/SSIM (and, with
    `testing.lpips`, LPIPS) per batch averaged over the batches, with
    `testing.fid` the FID of the samples against the train set, and
    results.json (main.py:261-314); with a `writer`, the first batch's
    samples and the scalars too. The condition, xT and the chain's noise
    come from one generator on the model's device, seeded with
    `testing.seed`."""
    dsc = config.dataset
    lik = parts["likelihood"]
    if lik is None:
        # a 'none'-likelihood config has nothing to condition on
        results = {"skipped": "likelihood 'none': no conditional eval"}
        with open(os.path.join(logdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        return results
    if cond_sample is None:
        cond_sample, _ = make_samplers(config, parts)
    device = next(model.parameters()).device
    lpips_fn = _get_lpips(device) if config.testing.lpips else None
    test = get_dataset(dsc.name)(dsc.root, train=False)
    bs = config.testing.batch_size
    num_batches = max(config.testing.num_test // bs, 1)
    gen = torch.Generator(device=device).manual_seed(config.testing.seed)
    stats = []
    samples, gts = [], []
    gen_for_fid = []
    n_eval = 0
    for b in range(num_batches):
        imgs = test.images[b * bs:(b + 1) * bs]
        if len(imgs) < bs:
            break
        imgs = torch.from_numpy(imgs).to(device)
        condition = lik.sample(gen, imgs)
        xT = torch.randn(imgs.shape, generator=gen, device=device)
        x0 = cond_sample(model, xT, condition, gen)
        batch_stats = {k: float(v) for k, v in
                       eval_statistics(x0, imgs).items()}
        if lpips_fn is not None:
            batch_stats["lpips"] = float(torch.mean(lpips_fn(x0, imgs)))
        stats.append(batch_stats)
        n_eval += len(imgs)
        if config.testing.fid:
            gen_for_fid.append(x0)
        if b == 0:
            samples, gts = x0.cpu().numpy(), imgs.cpu().numpy()
    results = {k: float(np.mean([s[k] for s in stats]))
               for k in (stats[0] if stats else {})}
    results["num_images"] = n_eval
    if config.testing.fid and gen_for_fid:
        # the metric loop's own samples are the fake side; the real-set
        # statistics are a function of (dataset, features, size, device)
        # and are computed once per run
        ck = (dsc.name, dsc.root, config.testing.fid_features,
              dsc.image_size, dsc.num_channels, str(device))
        if ck not in _FID_REAL_CACHE:
            feature_fn = make_feature_fn(config.testing.fid_features,
                                         channels=dsc.num_channels,
                                         device=device)
            train_set = get_dataset(dsc.name)(dsc.root, train=True)
            feats = [feature_fn(rb).cpu().numpy()
                     for rb in epoch_batches(train_set, bs)]
            _FID_REAL_CACHE[ck] = (
                feature_fn, compute_statistics(np.concatenate(feats)),
                getattr(train_set, "synthetic", False))
        feature_fn, (mu_r, s_r), real_synthetic = _FID_REAL_CACHE[ck]
        fake = np.concatenate([feature_fn(g).cpu().numpy()
                               for g in gen_for_fid])
        mu_f, s_f = compute_statistics(fake)
        results["fid"] = frechet_distance(mu_r, s_r, mu_f, s_f)
        results["fid_features"] = config.testing.fid_features
        results.update(fid_caveat(config.testing.fid_features,
                                  synthetic_data=real_synthetic
                                  or getattr(test, "synthetic", False)))
    with open(os.path.join(logdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if writer is not None and len(samples):
        writer.write_images(step, {f"{tag}_samples": samples[:64],
                                   f"{tag}_ground_truth": gts[:64]})
        writer.write_scalars(step, {f"{tag}/{k}": v
                                    for k, v in results.items()
                                    if isinstance(v, (int, float))})
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

    config = get_config(args.config)
    apply_overrides(config, args.override)
    device = resolve_device(args.device)
    initialize_distributed(device=device)
    mesh = make_mesh(model=config.mesh.model_axis)
    logdir = args.workdir or experiment_dir(config.logdir, args.config)
    os.makedirs(logdir, exist_ok=True)
    writer = MultiWriter([LocalWriter(logdir),
                          TensorBoardWriter(os.path.join(logdir, "tb"))])
    writer.log_hparams(config.to_dict())

    torch.manual_seed(config.training.seed)  # the model's random init
    parts = build(config, device, mesh)
    dsc = config.dataset
    train_ds = get_dataset(dsc.name)(dsc.root, train=True)

    num_steps = config.training.num_steps
    if num_steps == 0:
        num_steps = (config.training.epochs * len(train_ds)
                     // config.training.batch_size)
        config.training.num_steps = num_steps

    state, warm_started = init_state(config, parts, mesh)
    cond_sample, prior_sample = make_samplers(config, parts)
    train_step = make_train_step(
        make_loss(parts), ema_decay=config.training.ema_decay,
        ema_update_every=config.training.ema_update_every)
    ckpt = CheckpointManager(os.path.join(logdir, "ckpt"), maximum=3)
    # the EMA parameters are evaluated in a twin of the model
    ema_model = copy.deepcopy(state.model).eval().requires_grad_(False)

    n_params = sum(x.numel() for x in state.model.parameters())
    print(f"[main] {args.config} -> {logdir}; params={n_params / 1e6:.2f}M; "
          f"steps={num_steps}; device={device}")

    if args.mode in ("train", "all"):
        batches = infinite_batches(train_ds, config.training.batch_size,
                                   seed=config.training.seed)
        every = max(num_steps // 10, 1)

        def save_ckpt(step, state, **kw):
            ckpt.save(step, {"params": state.params, "ema": state.ema.params,
                             "step": step})

        def plot_samples(step, state, **kw):
            imgs = torch.from_numpy(train_ds.images[:16]).to(device)
            set_params(ema_model, state.ema.params)
            # one generator per plot, seeded from the step: mask placement,
            # prior noise and the chain's noise are successive draws
            gen = torch.Generator(device=device).manual_seed(
                (1 << 20) + step)
            xT = torch.randn(imgs.shape, generator=gen, device=device)
            if parts["likelihood"] is None:  # unconditional config
                x0 = prior_sample(ema_model, xT, gen)
                writer.write_images(step, {"samples": x0.cpu().numpy()})
                return
            cond = parts["likelihood"].sample(gen, imgs)
            x0 = cond_sample(ema_model, xT, cond, gen)
            writer.write_images(step, {
                "samples": x0.cpu().numpy(),
                "condition": cond.clamp(-1, 1).cpu().numpy()})

        def scalars(step, metrics, **kw):
            writer.write_scalars(step, metrics)

        results_per_step = []

        def periodic_eval(step, state, **kw):
            # conditional samples on the test set -> MSE/PSNR/SSIM
            # statistics, appended per eval period
            set_params(ema_model, state.ema.params)
            res = run_eval(config, parts, ema_model, logdir, writer,
                           step=step, tag="train_eval",
                           cond_sample=cond_sample)
            results_per_step.append({"step": step, "results": res})
            with open(os.path.join(logdir, "results_per_epoch.json"),
                      "w") as f:
                json.dump(results_per_step, f, indent=2)

        callbacks = [
            PeriodicCallback(callback_fn=scalars, every_steps=10),
            PeriodicCallback(callback_fn=save_ckpt, every_steps=every),
            PeriodicCallback(callback_fn=plot_samples, every_steps=every),
            PeriodicCallback(callback_fn=periodic_eval, every_steps=every),
        ]
        state = Trainer(train_step, state, batches, mesh=mesh,
                        callbacks=callbacks,
                        tensor_parallel=config.mesh.model_axis > 1
                        ).fit(num_steps)
        save_ckpt(state.step, state)

    results = None
    if args.mode in ("eval", "all"):
        ema_params = state.ema.params
        if args.mode == "eval":
            assets, restored_step = ckpt.load(
                {"params": state.params, "ema": state.ema.params, "step": 0})
            ema_params = assets["ema"]
            if not restored_step and warm_started:
                # no checkpoint in this workdir, but network.model_path
                # warm-started the parameters: evaluate a foreign trained
                # checkpoint under this config's conditioning
                print(f"[main] --mode eval: no local checkpoint; evaluating "
                      f"the {warm_started}-tensor warm-start from "
                      f"network.model_path")
            elif not restored_step:
                print("[main] WARNING: --mode eval found no checkpoint under "
                      "this workdir; evaluating RANDOM-INIT params (pass "
                      "--workdir pointing at a trained run)")
        set_params(ema_model, ema_params)
        results = run_eval(config, parts, ema_model, logdir, writer,
                           step=state.step, cond_sample=cond_sample)
        print("[main] eval:", json.dumps(results, indent=2))
    writer.flush()
    return results


if __name__ == "__main__":
    main()
