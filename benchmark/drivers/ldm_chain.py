"""Traffic kind `ldm_chain`: one client inpaints with the Stable Diffusion 2
inpainting UNet (`tpu_diffusion_torch/models/ldm_unet.py`), guided DDIM
chains back to back through the system's sampling main path:
`sampling/ancestral.py:make_ddim_sampler` (no x0 clipping) over
`classifier_free_eps_fn` (one UNet call on the 2B rows [prompt;
unconditional]) over `amortized_eps_fn` (the mask and the masked image's
latent as extra input channels), graphed (`sampling/graph.py:GraphCache`).
A request is one chain of `batch` latents, each with its own prompt
context, rectangle mask and masked-image latent, all drawn from the seed;
one unconditional context serves the whole run. The chain reads the
contexts and the condition from two buffers that each request overwrites
in place, so the captured step reads them by address.

Traffic parameters: batch, ddim_steps, guidance_scale, context_tokens,
mask_side (the least and the most rows and columns of a mask). The cell's
file gives `checked_chains`, how many of the window's chains (a sample
drawn from the seed) the reference checks, and the limits of the numbers
compared, each the largest over the checked chains:

  latent_gap:   the chain's end against the reference chain's from the
                same x_T, contexts, masks and latents: the largest over the
                images of the mean absolute difference;
  eps_gap:      the guided eps of the chain's first step on x_T, the
                system's (its chain body's model call, same module and
                kernels, made eagerly) against the reference's: the largest
                over the images of the mean absolute difference over the
                reference's mean absolute value;
  eps_gap_last: the same at the chain's last step, on the iterate the
                system's own chain reached there.

The reference (`reference/ldm_unet.py`) runs the conditional and the
unconditional forward apart; the control is the reference in fp8.
"""

from __future__ import annotations

import gc

import torch

from benchmark import inputs
from benchmark.counts.ldm_flops import forward_flops
from benchmark.reference.ldm_unet import (ddim_cfg_chain, guided_eps,
                                          make_weights, reference_unet,
                                          scaled_linear_abar)
from benchmark.reference.lowp import fp8


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the images of the mean absolute difference."""
    return float((got.float() - want).abs().flatten(1).mean(1).max())


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the images of the mean absolute difference over
    the mean absolute value of `want`."""
    diff = (got.float() - want).abs().flatten(1).mean(1)
    return float((diff / want.abs().flatten(1).mean(1)).max())


class Driver:
    def __init__(self, cell, seed: int, device, rehearse: bool = False):
        cfg, tr = dict(cell.config), dict(cell.traffic)
        self.limits = cell.workload["limits"]
        if rehearse:
            cfg.update(cfg["rehearsal"])
            tr.update(tr["rehearsal"])
            self.limits = cell.workload["rehearsal"]["limits"]
        self.cell, self.seed, self.device = cell, seed, device
        self.sizes = cfg["model"]
        self.sched = cfg["scheduler"]
        self.batch = tr["batch"]
        self.steps = tr["ddim_steps"]
        self.scale = tr["guidance_scale"]
        self.tokens = tr["context_tokens"]
        self.mask_side = tr["mask_side"]
        self.kept = []  # (x_T, condition, context, x0) of every chain

    # -- the system under test --------------------------------------------

    def setup(self) -> None:
        from tpu_diffusion_torch.core.schedules import (DDPM,
                                                        scaled_linear_betas)
        from tpu_diffusion_torch.models.ldm_unet import create_ldm_unet
        from tpu_diffusion_torch.sampling.ancestral import (
            amortized_eps_fn, classifier_free_eps_fn, make_ddim_sampler)
        from tpu_diffusion_torch.sampling.graph import GraphCache
        s, sc, dev = self.sizes, self.sched, self.device
        model = create_ldm_unet(dtype=torch.bfloat16, device=dev, **s)
        model.load_state_dict(make_weights(s, self.seed, dev))
        model.eval().requires_grad_(False)
        self.ddpm = DDPM.create(sc["num_train_timesteps"], scaled_linear_betas(
            sc["num_train_timesteps"], sc["beta_start"], sc["beta_end"]))
        b, side = self.batch, s["sample_size"]
        self.noise = inputs.generator(self.seed, inputs.NOISE, dev)
        self.draws = inputs.generator(self.seed, inputs.IMAGES, dev)
        self.ctx_u = torch.randn((1, self.tokens, s["cross_attention_dim"]),
                                 generator=self.draws, device=dev)
        # the rows [prompt contexts; unconditional] and the condition of
        # both halves, overwritten in place by each request
        self.ctx2 = self.ctx_u.repeat(2 * b, 1, 1)
        self.cond2 = torch.zeros((2 * b, side, side,
                                  s["in_channels"] - s["out_channels"]),
                                 device=dev)
        ctx2 = self.ctx2

        def unet(x, i):
            return model(x, i, ctx2)

        self.eps_fn = classifier_free_eps_fn(amortized_eps_fn(unet,
                                                              self.cond2),
                                             self.scale)
        self.graphs = GraphCache(model)
        self.sample = make_ddim_sampler(self.eps_fn, self.ddpm,
                                        num_steps=self.steps,
                                        graphs=self.graphs, clip=False)
        self.model = model
        # the cell's one shape: the first chain captures its step
        self._run(*self._request())
        self._sync()

    def _request(self):
        """x_T, the condition [mask, masked-image latent] and the prompt
        context of one request, from the seed's streams."""
        s, b, dev, g = self.sizes, self.batch, self.device, self.draws
        side, ch = s["sample_size"], s["out_channels"]
        x_T = torch.randn((b, side, side, ch), generator=self.noise,
                          device=dev)
        ctx = torch.randn((b, self.tokens, s["cross_attention_dim"]),
                          generator=g, device=dev)
        lo, hi = self.mask_side
        size = torch.randint(lo, hi + 1, (2, b, 1), generator=g, device=dev)
        origin = (torch.rand((2, b, 1), generator=g, device=dev)
                  * (side - size + 1)).floor()
        at = torch.arange(side, device=dev)
        inside = (at >= origin) & (at < origin + size)  # [2, b, side]
        mask = (inside[0][:, :, None] & inside[1][:, None, :]).float()
        latent = torch.randn((b, side, side, ch), generator=g, device=dev)
        return x_T, torch.cat([mask[..., None], latent], dim=-1), ctx

    def _fill(self, cond, ctx) -> None:
        self.ctx2[:self.batch].copy_(ctx)
        self.cond2.copy_(torch.cat([cond, cond]))

    def _run(self, x_T, cond, ctx) -> torch.Tensor:
        self._fill(cond, ctx)
        return self.sample(x_T)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        x_T, cond, ctx = self._request()
        x0 = self._run(x_T, cond, ctx)
        self._sync()
        self.kept.append((x_T, cond, ctx, x0))
        return self.batch

    def record_events(self, on: bool) -> None:
        """Have every replay record its CUDA events (or stop)."""
        if self.device.type == "cuda":
            self.graphs.events = [] if on else None

    def attempted(self) -> int:
        return len(self.kept)

    def failed(self) -> int:
        return sum(int(not torch.isfinite(k[-1]).all()) for k in self.kept)

    def routes(self) -> dict:
        """What engaged in the captured chain: each attention's route at
        its shape, the kernel launches a replay of the step makes."""
        chain = next(iter(self.graphs.chains.values()))

        def shapes(decisions):
            return sorted({"%s [%d,%d,%d] keys %d" % (
                d["route"], d["bh"], d["tq"], d["d"], d["tk"])
                for d in decisions.values()})

        return {
            "attention": shapes(self.model.attn_decisions),
            "cross_attention": shapes(self.model.xattn_decisions),
            "launches_per_replay": {str(len(sig)): n for sig, n in
                                    chain.launches.items()},
            "replays_per_chain": {str(len(sig)): n for sig, n in
                                  chain.replays.items()},
        }

    # -- what the readers read --------------------------------------------

    def counters(self) -> dict:
        chain = next(iter(self.graphs.chains.values()))
        # the guidance rows are real work: 2 rows an image a step
        flops = 2 * self.steps * forward_flops(self.sizes, self.tokens)
        return {"replay_device_s": (self.graphs.device_ms() / 1e3
                                    if self.graphs.events else None),
                "capture_s": sum(chain.capture_s.values()),
                "flops_per_item": flops,
                "kernel_calls": self._kernel_calls()}

    def _kernel_calls(self) -> dict:
        """The shapes of one chain's calls of the GroupNorm kernel (one
        eager step's norm calls, by module hooks), the flash forward and the
        cross-attention kernel (the model's decisions), each step's calls
        counted `ddim_steps` times."""
        from tpu_diffusion_torch.models.nn import FusedNormAct
        norms = []

        def hook(module, args):
            x = args[0]
            norms.append((x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                          False))

        handles = [m.register_forward_pre_hook(hook)
                   for m in self.model.modules()
                   if isinstance(m, FusedNormAct)]
        x, cond, ctx = self.kept[-1][:3]
        try:
            self._fill(cond, ctx)
            self.eps_fn(x, torch.zeros(self.batch, dtype=torch.int32,
                                       device=self.device))
        finally:
            for h in handles:
                h.remove()
        m, n = self.model, self.steps
        return {"gn_silu": norms * n,
                "flash_fwd": [(d["bh"], d["tq"], d["d"]) for d in
                              m.attn_decisions.values()
                              if d["route"] in ("wgmma", "mma")] * n,
                "xattn": [(d["bh"], d["tq"], d["tk"], d["d"]) for d in
                          m.xattn_decisions.values()
                          if d["route"] == "xattn"] * n}

    # -- correctness ------------------------------------------------------

    def _system_eps(self, picked) -> list:
        """For each picked chain, the system's guided eps at its first step
        on x_T, and the iterate its chain reached at the last step with the
        eps there: the eager chain (bitwise the graphed one's) through the
        same module and kernels, recording its model calls."""
        from tpu_diffusion_torch.sampling.ancestral import make_ddim_sampler
        out = []
        for x_T, cond, ctx, _ in picked:
            seen = []

            def record(xi, i):
                eps = self.eps_fn(xi, i)
                seen.append((xi, i[0].item(), eps))
                return eps

            self._fill(cond, ctx)
            make_ddim_sampler(record, self.ddpm, num_steps=self.steps,
                              clip=False)(x_T)
            out.append((seen[0][2], seen[-1]))
        return out

    def free_system(self) -> list:
        """The checked sample of chains with the system's eps readings; the
        system's state freed."""
        gen = torch.Generator().manual_seed(
            inputs.stream_seed(self.seed, inputs.CHECK))
        k = min(self.cell.workload["checked_chains"], len(self.kept))
        pick = torch.randperm(len(self.kept), generator=gen)[:k].tolist()
        picked = [self.kept[i] for i in sorted(pick)]
        eps = self._system_eps(picked)
        del self.model, self.graphs, self.sample, self.eps_fn
        self.kept = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return [p + e for p, e in zip(picked, eps)]

    def reference(self, lowp=None):
        return reference_unet(self.sizes, self.seed, self.device, lowp)

    def _abar(self):
        sc = self.sched
        return scaled_linear_abar(sc["num_train_timesteps"], sc["beta_start"],
                                  sc["beta_end"])

    def _gaps(self, ref, picked, wants, low=None) -> dict:
        """The numbers compared: the system's chains and eps (or, with
        `low`, the model `low`'s in the system's place) against `ref`'s,
        whose chain ends are `wants`."""
        abar, worst = self._abar(), {}
        first = int(self.ddpm.num_steps // self.steps) * (self.steps - 1)
        for p, want in zip(picked, wants):
            x_T, cond, ctx, x0, eps0, (x_last, i_last, eps_last) = p
            args = (cond, ctx, self.ctx_u, self.scale)
            if low is not None:
                x0, x_last = ddim_cfg_chain(low, x_T, *args[:3], abar,
                                            self.steps, self.scale)
                eps0 = guided_eps(low, x_T, first, *args)
                eps_last = guided_eps(low, x_last, i_last, *args)
            got = {"latent_gap": _gap(x0, want),
                   "eps_gap": _rel_gap(eps0, guided_eps(ref, x_T, first,
                                                        *args)),
                   "eps_gap_last": _rel_gap(eps_last, guided_eps(
                       ref, x_last.float(), i_last, *args))}
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def readings(self, control: bool = False) -> dict:
        """The numbers of the checked chains against the reference's, the
        system's state freed first; with `control`, the same numbers of the
        reference in fp8 put in the system's place on the same inputs."""
        picked = self.free_system()
        ref = self.reference()
        wants = [ddim_cfg_chain(ref, p[0], p[1], p[2], self.ctx_u,
                                self._abar(), self.steps, self.scale)[0]
                 for p in picked]
        out = {"system": self._gaps(ref, picked, wants)}
        if control:
            out["control"] = self._gaps(ref, picked, wants,
                                        self.reference(fp8))
        return out
