"""Traffic kind `flux_fill_chain`: one client inpaints with FLUX.1 Fill
[dev]'s transformer (`tpu_diffusion_torch/models/flux.py`), Euler chains
back to back through the system's flow-matching main path:
`sampling/ode.py:odeint_euler` on diffusers' shifted sigma grid
(`shifted_sigmas`, an input of the chain), over `amortized_velocity` (the
packed masked-image latent and mask as extra channels) over the model's
`velocity` (the guidance embedding at the traffic's scale: one model row
a step), graphed (`sampling/graph.py:GraphCache`). A request is one chain
of `batch` latents, each with its own x_T, T5 context, pooled CLIP vector,
rectangle mask at pixel resolution and masked-image latent, all drawn
from the seed. The chain reads the condition, context and pooled vector
from buffers that each request overwrites in place, so the captured step
reads them by address.

Traffic parameters: batch, image_size (pixels), euler_steps, guidance,
text_tokens, mask_side (the least and the most rows and columns of a
mask, in pixels). The cell's file gives `checked_chains`, how many of the
window's chains (a sample drawn from the seed) the reference checks, and
the limits of the numbers compared, each the largest over the checked
chains:

  latent_gap: the chain's end (packed tokens) against the reference
              chain's from the same x_T and inputs: the largest over the
              images of the mean absolute difference;
  v_gap:      the velocity of the chain's first step on x_T, the
              system's (its chain body's model call, same module and
              kernels, made once eagerly) against the reference's: the
              largest over the images of the mean absolute difference over
              the reference's mean absolute value.

The reference (`reference/flux.py`) packs the latent and the mask by its
own code and runs in fp32 from the same bf16 weights; the control is the
reference in fp8.
"""

from __future__ import annotations

import gc

import torch

from benchmark import inputs
from benchmark.counts.flux_flops import forward_flops
from benchmark.reference.flux import (euler_chain, fill_condition,
                                      load_weights, pack, reference_flux,
                                      sigmas)
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
        self.channels = cfg["vae"]["latent_channels"]
        self.scale = cfg["vae"]["scale_factor"]
        self.batch = tr["batch"]
        self.side = tr["image_size"]
        self.steps = tr["euler_steps"]
        self.guidance = tr["guidance"]
        self.tokens = tr["text_tokens"]
        self.mask_side = tr["mask_side"]
        self.latent = self.side // self.scale
        self.hw = (self.latent // 2, self.latent // 2)
        self.image_tokens = self.hw[0] * self.hw[1]
        self.kept = []  # (x_T, mask, latent, context, pooled, x_end)

    # -- the system under test --------------------------------------------

    def setup(self) -> None:
        from tpu_diffusion_torch.models.flux import create_flux
        from tpu_diffusion_torch.sampling.graph import GraphCache
        from tpu_diffusion_torch.sampling.ode import (amortized_velocity,
                                                      shifted_sigmas)
        s, dev, b = self.sizes, self.device, self.batch
        model = create_flux(dtype=torch.bfloat16, device=dev, **s)
        load_weights(model, s, self.seed, dev)
        model.eval().requires_grad_(False)
        sc = self.sched
        self.grid = shifted_sigmas(
            self.steps, self.image_tokens,
            base_image_seq_len=sc["base_image_seq_len"],
            max_image_seq_len=sc["max_image_seq_len"],
            base_shift=sc["base_shift"], max_shift=sc["max_shift"]).to(
                device=dev, dtype=torch.float32)
        self.noise = inputs.generator(self.seed, inputs.NOISE, dev)
        self.draws = inputs.generator(self.seed, inputs.IMAGES, dev)
        # the condition, context and pooled vector of the chain,
        # overwritten in place by each request
        self.cond = torch.zeros((b, self.image_tokens,
                                 s["in_channels"] - s["out_channels"]),
                                device=dev)
        self.ctx = torch.zeros((b, self.tokens, s["joint_attention_dim"]),
                               device=dev)
        self.pooled = torch.zeros((b, s["pooled_projection_dim"]),
                                  device=dev)
        self.v = amortized_velocity(
            model.velocity(self.guidance, self.ctx, self.pooled, self.hw),
            self.cond)
        self.graphs = GraphCache(model)
        self.model = model
        # the cell's one shape: the first chain captures its step
        self._run(self._request())
        self._sync()

    def _request(self):
        """x_T, the pixel mask, the masked image's latent, the T5 context
        and the pooled vector of one request, from the seed's streams."""
        s, b, dev, g = self.sizes, self.batch, self.device, self.draws
        lat = (b, self.channels, self.latent, self.latent)
        x_T = torch.randn(lat, generator=self.noise, device=dev)
        ctx = torch.randn((b, self.tokens, s["joint_attention_dim"]),
                          generator=g, device=dev)
        pooled = torch.randn((b, s["pooled_projection_dim"]), generator=g,
                             device=dev)
        lo, hi = self.mask_side
        size = torch.randint(lo, hi + 1, (2, b, 1), generator=g, device=dev)
        origin = (torch.rand((2, b, 1), generator=g, device=dev)
                  * (self.side - size + 1)).floor()
        at = torch.arange(self.side, device=dev)
        inside = (at >= origin) & (at < origin + size)  # [2, b, side]
        mask = (inside[0][:, :, None] & inside[1][:, None, :]).float()
        latent = torch.randn(lat, generator=g, device=dev)
        return x_T, mask[:, None], latent, ctx, pooled

    def _fill(self, req) -> None:
        from tpu_diffusion_torch.models.flux import pack_latents, pack_mask
        _, mask, latent, ctx, pooled = req[:5]
        self.cond.copy_(torch.cat([pack_latents(latent),
                                   pack_mask(mask, self.scale)], dim=-1))
        self.ctx.copy_(ctx)
        self.pooled.copy_(pooled)

    def _run(self, req) -> torch.Tensor:
        from tpu_diffusion_torch.models.flux import pack_latents
        from tpu_diffusion_torch.sampling.ode import odeint_euler
        self._fill(req)
        return odeint_euler(self.v, pack_latents(req[0]), graphs=self.graphs,
                            grid=self.grid)[0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        req = self._request()
        x_end = self._run(req)
        self._sync()
        self.kept.append(req + (x_end,))
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
        """What engaged in the captured chain: each block kind's attention
        route at its shape, the kernel launches a replay of the step
        makes."""
        chain = next(iter(self.graphs.chains.values()))
        return {
            "attention": sorted({"%s %s [%d,%d,%d] text %d image %d" % (
                d["kind"], d["route"], d["bh"], d["t"], d["d"], d["txt"],
                d["img"]) for d in self.model.attn_decisions.values()}),
            "blocks": {kind: sum(d["kind"] == kind for d in
                                 self.model.attn_decisions.values())
                       for kind in ("double", "single")},
            "launches_per_replay": {str(len(sig)): n for sig, n in
                                    chain.launches.items()},
            "replays_per_chain": {str(len(sig)): n for sig, n in
                                  chain.replays.items()},
        }

    # -- what the readers read --------------------------------------------

    def counters(self) -> dict:
        chain = next(iter(self.graphs.chains.values()))
        flops = self.steps * forward_flops(self.sizes, self.tokens, *self.hw)
        return {"replay_device_s": (self.graphs.device_ms() / 1e3
                                    if self.graphs.events else None),
                "capture_s": sum(chain.capture_s.values()),
                "flops_per_item": flops,
                "kernel_calls": self._kernel_calls()}

    def _kernel_calls(self) -> dict:
        """A chain's flash forward calls, [BH, T, d] each: the blocks'
        decisions (one joint attention a block), `euler_steps` times."""
        return {"flash_fwd": [(d["bh"], d["t"], d["d"]) for d in
                              self.model.attn_decisions.values()
                              if d["route"] in ("wgmma", "mma")]
                * self.steps}

    # -- correctness ------------------------------------------------------

    def _system_v(self, picked) -> list:
        """For each picked chain, the system's velocity at its first step
        on x_T: one eager call of the chain body's velocity, the same
        module and kernels."""
        from tpu_diffusion_torch.models.flux import pack_latents
        out = []
        with torch.no_grad():
            for req in picked:
                self._fill(req)
                out.append(self.v(self.grid[0], pack_latents(req[0])))
        return out

    def free_system(self) -> list:
        """The checked sample of chains with the system's velocity
        readings; the system's state freed."""
        gen = torch.Generator().manual_seed(
            inputs.stream_seed(self.seed, inputs.CHECK))
        k = min(self.cell.workload["checked_chains"], len(self.kept))
        pick = torch.randperm(len(self.kept), generator=gen)[:k].tolist()
        picked = [self.kept[i] for i in sorted(pick)]
        vs = self._system_v(picked)
        del self.model, self.graphs, self.v
        self.kept = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return [p + (v,) for p, v in zip(picked, vs)]

    def reference(self, lowp=None):
        return reference_flux(self.sizes, self.seed, self.device, lowp)

    def _grid(self):
        return sigmas(self.steps, self.image_tokens, self.sched).astype(
            "float32")

    def _gaps(self, picked, wants, low=None) -> dict:
        """The numbers compared: the system's chains and velocities (or,
        with `low`, the model `low`'s in the system's place) against the
        reference's chains' (end, first velocity), `wants`."""
        grid, worst = self._grid(), {}
        for p, (want, want_v0) in zip(picked, wants):
            x_T, mask, latent, ctx, pooled, x_end, v0 = p
            if low is not None:
                x_end, v0 = euler_chain(
                    low, pack(x_T), fill_condition(mask, latent, self.scale),
                    ctx, pooled, self.guidance, grid, self.hw)
            got = {"latent_gap": _gap(x_end, want),
                   "v_gap": _rel_gap(v0, want_v0)}
            for key, val in got.items():
                worst[key] = max(worst.get(key, 0.0), val)
        return worst

    def readings(self, control: bool = False) -> dict:
        """The numbers of the checked chains against the reference's, the
        system's state freed first; with `control`, the same numbers of the
        reference in fp8 put in the system's place on the same inputs."""
        picked = self.free_system()
        ref = self.reference()
        grid = self._grid()
        wants = []
        for p in picked:
            x_T, mask, latent, ctx, pooled = p[:5]
            wants.append(euler_chain(
                ref, pack(x_T), fill_condition(mask, latent, self.scale),
                ctx, pooled, self.guidance, grid, self.hw))
        del ref
        out = {"system": self._gaps(picked, wants)}
        if control:
            out["control"] = self._gaps(picked, wants, self.reference(fp8))
        return out
