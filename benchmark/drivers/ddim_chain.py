"""Traffic kind `ddim_chain`: one client samples DDIM chains back to back,
each from a fresh x_T drawn from the seed, through the system's sampling
main path: the fused-inference engine (`models/unet_infer.py:
make_fused_apply`) under graphed chains (`sampling/graph.py:GraphCache`),
K=1 by `sampling/ancestral.py:make_ddim_sampler` and K>1 (encoder reuse)
by `make_cached_ddim_sampler`. A request is one chain of `batch` images.

Traffic parameters: batch, ddim_steps, encoder_reuse (1: plain DDIM).
The cell's file gives `checked_chains`, how many of the chains the window
finished (a sample drawn from the seed) the reference samples again, and
the limits of the numbers compared:

  image_gap: the largest, over the checked images, of the mean absolute
             difference between the system's x0 and the reference's.
"""

from __future__ import annotations

import gc
import math

import torch

from benchmark import inputs
from benchmark.counts.flops import forward_flops
from benchmark.reference.diffusion import ddim_chain
from benchmark.reference.lowp import fp8


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
        self.cfg = cfg
        self.batch = tr["batch"]
        self.steps = tr["ddim_steps"]
        self.reuse = tr["encoder_reuse"]
        self.num_steps = cfg["diffusion_steps"]
        self.kept = []  # (x_T, x0) of every chain run after set-up

    # -- the system under test --------------------------------------------

    def setup(self) -> None:
        from tpu_diffusion_torch.core.schedules import DDPM
        from tpu_diffusion_torch.models.unet import create_model
        from tpu_diffusion_torch.models.unet_infer import make_fused_apply
        from tpu_diffusion_torch.sampling.ancestral import (
            make_cached_ddim_sampler, make_ddim_sampler)
        from tpu_diffusion_torch.sampling.graph import GraphCache
        s, sys_cfg = self.sizes, self.cfg["system"]
        model = create_model(
            image_size=s["image_size"], num_channels=s["num_channels"],
            num_res_blocks=s["num_res_blocks"], in_channels=s["in_channels"],
            out_channels=s["out_channels"],
            channel_mult=tuple(s["channel_mult"]), num_heads=s["num_heads"],
            num_head_channels=s["num_head_channels"],
            attention_resolutions=",".join(
                str(r) for r in s["attention_resolutions"]),
            use_scale_shift_norm=True, dtype=torch.bfloat16,
            attention_impl=sys_cfg["attention_impl"],
            norm_impl=sys_cfg["norm_impl"], device=self.device)
        model.load_state_dict(inputs.make_weights(s, self.seed, self.device))
        model.eval().requires_grad_(False)
        engine = make_fused_apply(model)
        ddpm = DDPM.create(self.num_steps)
        graphs = GraphCache(model)
        n = self.num_steps

        def call(xi, i, **kw):
            return engine(xi, i.float() / n, **kw)

        if self.reuse > 1:
            sample = make_cached_ddim_sampler(
                lambda xi, i: call(xi, i, mode="encode"),
                lambda xi, i, c: call(xi, i, mode="decode", cache=c), ddpm,
                num_steps=self.steps, encoder_reuse=self.reuse,
                graphs=graphs)
        else:
            sample = make_ddim_sampler(call, ddpm, num_steps=self.steps,
                                       graphs=graphs)
        self.model, self.engine, self.graphs, self.sample = (
            model, engine, graphs, sample)
        self.noise = inputs.generator(self.seed, inputs.NOISE, self.device)
        # the cell's one shape: the first chain captures its bodies
        self.sample(self._x_T())
        self._sync()

    def _x_T(self) -> torch.Tensor:
        s = self.sizes
        return torch.randn((self.batch, s["image_size"], s["image_size"],
                            s["out_channels"]), generator=self.noise,
                           device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        x_T = self._x_T()
        x0 = self.sample(x_T)
        self._sync()
        self.kept.append((x_T, x0))
        return self.batch

    def record_events(self, on: bool) -> None:
        """Have every replay record its CUDA events (or stop)."""
        if self.device.type == "cuda":
            self.graphs.events = [] if on else None

    def attempted(self) -> int:
        return len(self.kept)

    def failed(self) -> int:
        return sum(int(not torch.isfinite(x0).all()) for _, x0 in self.kept)

    def routes(self) -> dict:
        """What engaged in the captured chain: the attention
        implementations, the ResBlocks on the whole-ResBlock kernel, the
        kernel launches a replay of each body makes."""
        chain = next(iter(self.graphs.chains.values()))
        return {
            "attention": sorted({d["impl"] for d in
                                 self.model.attn_decisions.values()}),
            "resblocks_on_kernel": sorted(
                k for k, d in self.engine.res_decisions.items()
                if d["impl"] == "kernel"),
            "launches_per_replay": {str(len(sig)): n for sig, n in
                                    chain.launches.items()},
            "replays_per_chain": {str(len(sig)): n for sig, n in
                                  chain.replays.items()},
        }

    # -- what the readers read --------------------------------------------

    def counters(self) -> dict:
        chain = next(iter(self.graphs.chains.values()))
        s = self.sizes
        groups = math.ceil(self.steps / self.reuse)
        if self.reuse > 1:
            flops = (forward_flops(s, "encode") * groups
                     + forward_flops(s, "decode") * self.steps)
        else:
            flops = forward_flops(s) * self.steps
        return {"replay_device_s": (self.graphs.device_ms() / 1e3
                                    if self.graphs.events else None),
                "capture_s": sum(chain.capture_s.values()),
                "flops_per_item": flops,
                "kernel_calls": self._kernel_calls()}

    def _kernel_calls(self) -> dict:
        """The shapes of one chain's calls of the whole-ResBlock and the
        GroupNorm kernels: the engine's ResBlock decisions and one eager
        forward's norm calls (module hooks), by encoder and decoder pass,
        each pass counted as often as a chain runs it."""
        from tpu_diffusion_torch.models.nn import FusedNormAct
        b, groups = self.batch, math.ceil(self.steps / self.reuse)
        res = []
        for name, d in self.engine.res_decisions.items():
            if d["impl"] != "kernel":
                continue
            side = math.isqrt(d["tokens"])
            runs = groups if (self.reuse > 1 and name.startswith("enc_")) \
                else self.steps
            res += [(b, side, side, d["cin"], d["cout"])] * runs
        norms = []

        def hook(module, args, kwargs):
            x = args[0]
            film = (len(args) > 1 and args[1] is not None) or \
                kwargs.get("film") is not None
            norms.append((x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                          film))

        handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
                   for m in self.model.modules()
                   if isinstance(m, FusedNormAct)]
        x = self._x_T()
        t = torch.zeros(self.batch, device=self.device)
        try:
            if self.reuse > 1:
                cache = self.engine(x, t, mode="encode")
                enc = len(norms)
                self.engine(x, t, mode="decode", cache=cache)
                gn = norms[:enc] * groups + norms[enc:] * self.steps
            else:
                self.engine(x, t)
                gn = norms * self.steps
        finally:
            for h in handles:
                h.remove()
        return {"resblock": res, "gn_silu": gn}

    # -- correctness ------------------------------------------------------

    def free_system(self) -> list:
        """The checked sample of chains; the system's state freed."""
        gen = torch.Generator().manual_seed(
            inputs.stream_seed(self.seed, inputs.CHECK))
        k = min(self.cell.workload["checked_chains"], len(self.kept))
        pick = torch.randperm(len(self.kept), generator=gen)[:k].tolist()
        picked = [self.kept[i] for i in sorted(pick)]
        del self.model, self.engine, self.graphs, self.sample
        self.kept = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return picked

    def reference(self, lowp=None):
        return inputs.reference_unet(self.sizes, self.seed, self.device,
                                     lowp)

    def _gaps(self, picked, model) -> dict:
        """The numbers compared, of `picked` (x_T, x0) against `model`'s
        chains from the same x_T."""
        worst = 0.0
        for x_T, x0 in picked:
            want = ddim_chain(model, x_T, self.num_steps, self.steps,
                              self.reuse)
            gap = (x0.float() - want).abs().flatten(1).mean(1)
            worst = max(worst, float(gap.max()))
        return {"image_gap": worst}

    def readings(self, control: bool = False) -> dict:
        """The numbers of the checked chains against the reference's, the
        system's state freed first; with `control`, the same numbers of
        the reference in fp8 put in the system's place on the same x_T."""
        picked = self.free_system()
        ref = self.reference()
        out = {"system": self._gaps(picked, ref)}
        if control:
            low = self.reference(fp8)
            out["control"] = self._gaps(
                [(x_T, ddim_chain(low, x_T, self.num_steps, self.steps,
                                  self.reuse)) for x_T, _ in picked], ref)
        return out
