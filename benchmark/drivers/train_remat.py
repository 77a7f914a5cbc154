"""Traffic kind `train_remat`: `train_step`'s graphed training step (its
set-up, requests, counters and numbers compared, `drivers/train_step.py`)
with every ResBlock of the UNet recomputed in the backward
(`UNetModel.use_checkpoint`, `torch.utils.checkpoint`), as guided-
diffusion's `use_checkpoint` trades recomputation for activation memory.
The flag is set on the model that `cli/main.py:build` returns, before the
Trainer is made; the configuration has no key for it. The reference's
step is the plain one: recomputation changes no number it compares.
"""

from __future__ import annotations

from benchmark.drivers import train_step


class Driver(train_step.Driver):
    def setup(self) -> None:
        from tpu_diffusion_torch.cli import main as cli
        build = cli.build

        def build_remat(config, device):
            parts = build(config, device)
            parts["model"].use_checkpoint = True
            return parts

        cli.build = build_remat
        try:
            super().setup()
        finally:
            cli.build = build

    def routes(self) -> dict:
        return {**super().routes(),
                "use_checkpoint": self.trainer.state.model.use_checkpoint}
