"""Traffic kind `amortized_chain`: one client inpaints 64px images as
`python -m tpu_diffusion_torch.cli.main --mode sample` does, chains back
to back through `cli.main`'s own conditional sampler: the parts from
`cli/main.py:build`, the sampler from `make_samplers(config, parts)`'s
`cond_sample` (amortized conditioning with `testing.encoder_reuse` K:
`sampling/ancestral.py:make_cached_amortized_sampler`, the DDPM ancestral
chain of the model's `diffusion_steps`, graphed). A request is one chain of
`batch` images: a fresh image batch (uniform noise from the seed), its
condition drawn by the likelihood (the configuration's inpainting patch at
its pad value), x_T, and the chain's noise, all from one generator on the
card in `run_eval`'s order.

Traffic parameters: batch, diffusion_steps, encoder_reuse. The cell's file
gives `checked_chains` and `checked_images`: of that many of the window's
chains (a sample drawn from the seed) the reference samples
`checked_images` of the batch's images again (drawn from the seed, half of
them from each half of the batch), from the same x_T, condition and
generator state, on their slices of the batch's draws
(`reference/ancestral.py`; the rehearsal block may give fewer); and the
limits of the number compared:

  image_gap: the largest, over the checked images, of the mean absolute
             difference between the system's x0 and the reference's.
"""

from __future__ import annotations

import gc
import math

import torch

from benchmark import inputs
from benchmark.counts.flops import forward_flops
from benchmark.reference.ancestral import amortized_chain
from benchmark.reference.lowp import fp8


class Driver:
    def __init__(self, cell, seed: int, device, rehearse: bool = False):
        cfg, tr = dict(cell.config), dict(cell.traffic)
        self.limits = cell.workload["limits"]
        self.checked_images = cell.workload["checked_images"]
        if rehearse:
            cfg.update(cfg["rehearsal"])
            tr.update(tr["rehearsal"])
            self.limits = cell.workload["rehearsal"]["limits"]
            self.checked_images = cell.workload["rehearsal"].get(
                "checked_images", self.checked_images)
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cfg
        # the configuration's rehearsal UNet attends over 1024 tokens (60 ms
        # a step on one CPU thread): the traffic's rehearsal block may give
        # a smaller one, so that a rehearsal window holds several chains
        self.sizes = tr.get("model", cfg["model"])
        self.hp = cfg["training"]
        self.batch = tr["batch"]
        self.num_steps = tr["diffusion_steps"]
        self.reuse = tr["encoder_reuse"]
        self.kept = []  # (x_T, condition, generator state, x0) per chain

    def _config(self):
        """`cli.main`'s configuration of the spec, with this cell's
        values."""
        from tpu_diffusion_torch.utils.config import get_config
        s, hp = self.sizes, self.hp
        c = get_config(self.cfg["cli_spec"])
        c.dataset.image_size = s["image_size"]
        c.network.num_channels = s["num_channels"]
        c.network.channel_mult = ",".join(str(m) for m in s["channel_mult"])
        c.network.num_res_blocks = s["num_res_blocks"]
        c.network.num_heads = s["num_heads"]
        c.network.num_head_channels = s["num_head_channels"]
        c.network.attention_resolutions = ",".join(
            str(r) for r in s["attention_resolutions"])
        c.network.use_scale_shift_norm = True
        c.network.dropout = 0.0
        c.network.attention_impl = self.cfg["system"]["attention_impl"]
        c.network.dtype = "bfloat16"
        c.network.model_path = ""  # no warm start: the seed's weights
        c.likelihood.patch_size = hp["patch_size"]
        c.likelihood.pad_value = hp["pad_value"]
        c.diffusion.num_steps = self.num_steps
        c.testing.batch_size = self.batch
        c.testing.encoder_reuse = self.reuse
        return c

    # -- the system under test --------------------------------------------

    def setup(self) -> None:
        from tpu_diffusion_torch.cli import main as cli
        config = self._config()
        parts = cli.build(config, self.device)
        model = parts["model"]
        model.load_state_dict(inputs.make_weights(self.sizes, self.seed,
                                                  self.device))
        model.eval().requires_grad_(False)
        self.cond_sample, _ = cli.make_samplers(config, parts)
        self.model, self.lik = model, parts["likelihood"]
        self.gen = inputs.generator(self.seed, inputs.NOISE, self.device)
        self.images = inputs.generator(self.seed, inputs.IMAGES, self.device)
        # the cell's one shape: the first chain captures its bodies
        self._chain()
        self._sync()
        self.graphs = self.cond_sample.built["graphs"]

    def _chain(self):
        side = self.sizes["image_size"]
        imgs = torch.rand((self.batch, side, side, 3), generator=self.images,
                          device=self.device) * 2 - 1
        condition = self.lik.sample(self.gen, imgs)
        x_T = torch.randn(imgs.shape, generator=self.gen, device=self.device)
        state = self.gen.get_state()
        return x_T, condition, state, self.cond_sample(self.model, x_T,
                                                       condition, self.gen)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        kept = self._chain()
        self._sync()
        self.kept.append(kept)
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
        """What engaged in the captured chain: the attention
        implementations by token count, the kernel launches a replay of
        each body makes."""
        chain = next(iter(self.graphs.chains.values()))
        return {
            "attention": sorted({"%s T=%d" % (d["impl"], d["tokens"]) for d
                                 in self.model.attn_decisions.values()}),
            "launches_per_replay": {str(len(sig)): n for sig, n in
                                    chain.launches.items()},
            "replays_per_chain": {str(len(sig)): n for sig, n in
                                  chain.replays.items()},
        }

    # -- what the readers read --------------------------------------------

    def _groups(self) -> int:
        return math.ceil(self.num_steps / self.reuse)

    def counters(self) -> dict:
        chain = next(iter(self.graphs.chains.values()))
        s = self.sizes
        flops = (forward_flops(s, "encode") * self._groups()
                 + forward_flops(s, "decode") * self.num_steps)
        return {"replay_device_s": (self.graphs.device_ms() / 1e3
                                    if self.graphs.events else None),
                "capture_s": sum(chain.capture_s.values()),
                "flops_per_item": flops,
                "kernel_calls": self._kernel_calls()}

    def _kernel_calls(self) -> dict:
        """The shapes of one chain's calls of the GroupNorm kernel and the
        flash forward: one eager encoder and decoder pass's norm calls
        (module hooks) and attention decisions, the encoder's counted once
        a group and the decoder's every step."""
        from tpu_diffusion_torch.models.nn import FusedNormAct
        norms = []

        def hook(module, args, kwargs):
            x = args[0]
            film = (len(args) > 1 and args[1] is not None) or \
                kwargs.get("film") is not None
            norms.append((x.shape[0], x.shape[2], x.shape[3], x.shape[1],
                          film))

        def attn(names):
            d = self.model.attn_decisions
            return [(self.batch * d[n]["heads"], d[n]["tokens"],
                     self.sizes["num_head_channels"]) for n in names
                    if d[n]["impl"] == "flash"]

        handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
                   for m in self.model.modules()
                   if isinstance(m, FusedNormAct)]
        x_T, cond = self.kept[-1][:2]
        x = torch.cat([x_T, cond], dim=-1)
        t = torch.zeros(self.batch, device=self.device)
        try:
            with torch.no_grad():
                self.model.attn_decisions.clear()
                cache = self.model(x, t, mode="encode")
                enc, enc_attn = len(norms), list(self.model.attn_decisions)
                self.model(x, t, mode="decode", cache=cache)
        finally:
            for h in handles:
                h.remove()
        dec_attn = [n for n in self.model.attn_decisions if n not in enc_attn]
        g, n = self._groups(), self.num_steps
        return {"gn_silu": norms[:enc] * g + norms[enc:] * n,
                "flash_fwd": attn(enc_attn) * g + attn(dec_attn) * n}

    # -- correctness ------------------------------------------------------

    def free_system(self) -> list:
        """The checked sample of chains, and of their images in `rows`
        (the first half of them from the batch's first half, the rest from
        its second); the system's state freed."""
        gen = torch.Generator().manual_seed(
            inputs.stream_seed(self.seed, inputs.CHECK))
        k = min(self.cell.workload["checked_chains"], len(self.kept))
        pick = torch.randperm(len(self.kept), generator=gen)[:k].tolist()
        picked = [self.kept[i] for i in sorted(pick)]
        n = min(self.checked_images, self.batch)
        h = (self.batch + 1) // 2
        self.rows = sorted(
            torch.randperm(h, generator=gen)[:(n + 1) // 2].tolist()
            + (h + torch.randperm(self.batch - h, generator=gen)[:n // 2]
               ).tolist())
        del self.model, self.cond_sample, self.lik, self.graphs
        self.kept = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return picked

    def reference(self, lowp=None):
        return inputs.reference_unet(self.sizes, self.seed, self.device,
                                     lowp)

    def _chain_of(self, model, x_T, cond, state) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        return amortized_chain(model, x_T, cond, gen, self.num_steps,
                               self.reuse, self.rows)

    def readings(self, control: bool = False) -> dict:
        """The numbers of the checked images against the reference's, the
        system's state freed first; with `control`, the same numbers of the
        reference in fp8 put in the system's place on the same inputs and
        draws."""
        picked = self.free_system()
        ref = self.reference()
        low = self.reference(fp8) if control else None
        worst = {"system": 0.0, "control": 0.0}
        for x_T, cond, state, x0 in picked:
            want = self._chain_of(ref, x_T, cond, state)
            got = {"system": x0[self.rows]}
            if low is not None:
                got["control"] = self._chain_of(low, x_T, cond, state)
            for side, x in got.items():
                gap = (x.float() - want).abs().flatten(1).mean(1)
                worst[side] = max(worst[side], float(gap.max()))
        out = {"system": {"image_gap": worst["system"]}}
        if control:
            out["control"] = {"image_gap": worst["control"]}
        return out
