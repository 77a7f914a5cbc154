"""Traffic kind `train_step`: the system's graphed training step, as
`python -m tpu_diffusion_torch.cli.main --mode train` runs it: the parts
from `cli/main.py:build`, the state from `init_state`, the step
`train/trainer.py:make_train_step(make_loss(parts))` (the amortized
condition-dropout objective, its backward, clipping, Adam, the EMA), fed
by `Trainer.fit`, whose steps replay one captured CUDA graph
(`train/graph.py:StepGraphs`) after two eager warm-ups. A request is
`steps_per_request` steps of `batch` images from a pool the seed makes.

Set-up builds one Trainer and runs its first `checked_steps` steps through
`fit` (the warm-ups, the capture and the replays after it, past the EMA's
first blend), recording each step's loss, each parameter's gradient norm
as Adam got it after the first step (its first moment over 1 - b1), and
the change of each parameter and of its EMA over the steps; the window
goes on with the same Trainer. The reference follows those steps from the
same weights, images and draws. `compare` works out, for each parameter,
the gap between the system's and the reference's norms over the larger of
the reference's norm and the median parameter's:

  update_gap:        the largest gap of the parameters' changes over the
                     steps, each change taken over the entries whose first
                     reference gradient is not nought to rounding;
  update_gap_median: the median parameter's gap of those changes;
  ema_gap:           the largest gap of the EMA's changes, over the same
                     entries;
  ema_gap_median:    the median parameter's gap of the EMA's changes;
  loss_gap:          the largest over the steps of |loss - reference| /
                     reference;
  grad_gap_median:   the median parameter's gap of the first gradient's
                     norms as Adam got it.

The cell's file holds the limits of the numbers compared; the others are
worked out for the record of `benchmark/calibrate.py` only.

The reference redraws each step's patch origins, condition drop, steps
and noise from the seed in the order and the shapes in which the system's
objective draws them (`reference/diffusion.py:amortized_draws`): a change
of the system's draw order has to change that function with it.
"""

from __future__ import annotations

import gc
import statistics

import torch

from benchmark import inputs
from benchmark.counts.flops import forward_flops
from benchmark.reference.diffusion import amortized_loss, train
from benchmark.reference.lowp import fp8

B1 = 0.9  # Adam's first-moment decay, for the gradient from the moment


class Driver:
    def __init__(self, cell, seed: int, device, rehearse: bool = False):
        cfg, tr = dict(cell.config), dict(cell.traffic)
        self.limits = cell.workload["limits"]
        if rehearse:
            cfg.update(cfg["rehearsal"])
            tr.update(tr["rehearsal"])
            self.limits = cell.workload["rehearsal"]["limits"]
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.tr = cfg, tr
        self.sizes = cfg["model"]
        self.hp = cfg["training"]
        self.batch = tr["batch"]
        self.per_request = tr["steps_per_request"]
        self.steps_done = 0

    def _config(self):
        """`cli.main`'s configuration of the spec, with this file's
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
        c.training.batch_size = self.batch
        for k in ("learning_rate", "warmup", "lr_schedule", "num_steps",
                  "grad_clip", "ema_decay", "ema_update_every"):
            c.training[k] = hp[k]
        c.training.seed = inputs.stream_seed(self.seed, inputs.TRAIN_DRAWS)
        c.conditioning.p_cond = hp["p_cond"]
        c.likelihood.patch_size = hp["patch_size"]
        c.likelihood.pad_value = hp["pad_value"]
        c.diffusion.num_steps = hp["diffusion_steps"]
        return c

    def _images(self) -> torch.Tensor:
        return inputs.make_images(self.tr["image_pool"],
                                  self.sizes["image_size"], self.seed,
                                  self.device)

    def _batches(self):
        pool, b, at = self._images(), self.batch, 0
        while True:
            if at + b > len(pool):
                at = 0
            yield pool[at:at + b]
            at += b

    def setup(self) -> None:
        from tpu_diffusion_torch.cli import main as cli
        from tpu_diffusion_torch.train.trainer import (Trainer,
                                                       make_train_step)
        config = self._config()
        parts = cli.build(config, self.device)
        model = parts["model"]
        model.load_state_dict(inputs.make_weights(self.sizes, self.seed,
                                                  self.device))
        state, _ = cli.init_state(config, parts)
        tr = config.training
        step = make_train_step(cli.make_loss(parts), ema_decay=tr.ema_decay,
                               ema_update_every=tr.ema_update_every,
                               ema_warmup=self.hp["ema_warmup"])
        self.trainer = Trainer(step, state, self._batches())
        named = list(model.named_parameters())
        start = [p.detach().clone() for _, p in named]
        losses = []

        def hook(step, metrics):
            losses.append(metrics["loss"])

        self.trainer.fit(1, metrics_hook=hook)
        moments = state.optimizer.state
        grads = {n: float(moments[p]["exp_avg"].norm()) / (1 - B1)
                 for n, p in named}
        self.trainer.fit(self.tr["checked_steps"] - 1, metrics_hook=hook)
        ema = state.ema.params
        change = {n: p.detach() - s for (n, p), s in zip(named, start)}
        ema_change = {n: ema[n] - s for (n, _), s in zip(named, start)}
        del start
        self.readings_of_system = dict(losses=losses, grad_norms=grads,
                                       change=change, ema_change=ema_change)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> int:
        self.trainer.fit(self.per_request)
        self._sync()
        self.steps_done += self.per_request
        return self.per_request * self.batch

    def record_events(self, on: bool) -> None:
        """Have every replay record its CUDA events (or stop)."""
        if self.trainer.graphs is not None and self.device.type == "cuda":
            self.trainer.graphs.events = [] if on else None

    def attempted(self) -> int:
        return self.steps_done

    def failed(self) -> int:
        """All the window's steps where a parameter is not finite after
        them (a NaN or an infinity stays), else none."""
        params = list(self.trainer.state.model.parameters())
        norms = torch.stack(torch._foreach_norm(params))
        return 0 if bool(torch.isfinite(norms).all()) else self.steps_done

    def routes(self) -> dict:
        model = self.trainer.state.model
        return {"trainer": self.trainer.route(),
                "attention": {k: d["impl"] for k, d in
                              model.attn_decisions.items()},
                "launches_per_replay": {
                    str(k[0]): e.launches for k, e in
                    self.trainer.graphs.captured().items()}
                if self.trainer.graphs else {}}

    # -- what the readers read --------------------------------------------

    def counters(self) -> dict:
        graphs = self.trainer.graphs
        events = graphs.events if graphs is not None else None
        device_s = None
        if events:
            events[-1][1].synchronize()
            device_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
        captured = graphs.captured() if graphs is not None else {}
        return {"replay_device_s": device_s,
                "capture_s": sum(e.capture_s for e in captured.values()),
                # forward and backward: three forwards' products
                "flops_per_item": 3 * forward_flops(self.sizes),
                "kernel_calls": self._kernel_calls()}

    def _kernel_calls(self) -> dict:
        """A request's flash forward and backward calls, [BH, T, d] each,
        from the attention blocks' decisions at the capture."""
        model = self.trainer.state.model
        fwd = []
        for name, d in model.attn_decisions.items():
            if d["impl"] != "flash":
                continue
            c = getattr(model, name).qkv.in_features
            fwd.append((self.batch * d["heads"], d["tokens"],
                        c // d["heads"]))
        fwd *= self.per_request
        return {"flash_fwd": fwd, "flash_bwd": fwd}

    # -- correctness ------------------------------------------------------

    def free_system(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lowp=None):
        return inputs.reference_unet(self.sizes, self.seed, self.device,
                                     lowp)

    def reference_readings(self, lowp=None, loss_fn=None) -> dict:
        """The reference's steps (in `lowp`, or with another objective)
        over the same batches and draws."""
        pool = self._images()
        n = self.tr["checked_steps"]
        batches = [pool[k * self.batch:(k + 1) * self.batch]
                   for k in range(n)]
        gen = inputs.generator(self.seed, inputs.TRAIN_DRAWS, self.device)
        kw = {} if loss_fn is None else {"loss_fn": loss_fn}
        return train(self.reference(lowp), batches, gen, self.hp, **kw)

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The numbers of `got` against the reference's `want`. The
        changes leave out every entry whose first reference gradient is
        under a thousandth of the median parameter's root-mean-square one:
        such entries (a key's bias under the softmax, a bias before a norm
        that takes its group's mean) get gradients of rounding alone, which
        Adam scales up to whole steps."""
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
        grads = want["grads"]
        rms = statistics.median(float(g.norm()) / g.numel() ** 0.5
                                for g in grads.values())
        changes, emas = {}, {}
        for n, g in grads.items():
            keep = g.abs() >= 1e-3 * rms
            if bool(keep.any()):
                changes[n] = (float(got["change"][n][keep].norm()),
                              float(want["change"][n][keep].norm()))
                emas[n] = (float(got["ema_change"][n][keep].norm()),
                           float(want["ema_change"][n][keep].norm()))

        def gaps(pairs):
            med = statistics.median(b for _, b in pairs.values())
            return [abs(a - b) / max(b, med) for a, b in pairs.values()]

        norms = want["grad_norms"]
        return {"loss_gap": loss,
                "grad_gap_median": statistics.median(gaps(
                    {n: (got["grad_norms"][n], b) for n, b in norms.items()})),
                "update_gap": max(gaps(changes)),
                "update_gap_median": statistics.median(gaps(changes)),
                "ema_gap": max(gaps(emas)),
                "ema_gap_median": statistics.median(gaps(emas))}

    def readings(self, control: bool = False) -> dict:
        """The numbers of the set-up's steps against the reference's, the
        system's state freed first; with `control`, the same numbers of
        the reference in fp8 and of the reference with half of the batch
        left out, each put in the system's place."""
        got = self.readings_of_system
        self.free_system()
        want = self.reference_readings()
        out = {"system": self.compare(got, want)}
        if control:
            out["control"] = self.compare(self.reference_readings(fp8), want)
            out["half_batch"] = self.compare(
                self.reference_readings(loss_fn=half_batch_loss), want)
        return out


def half_batch_loss(model, x, d, tr, abar):
    """The fault "half of the batch left out, the mean taken over the
    rest": the amortized loss of the first half of the batch alone."""
    h = x.shape[0] // 2
    d = {k: (v if v.ndim == 0 else v[:h]) for k, v in d.items()}
    return amortized_loss(model, x[:h], d, tr, abar)
