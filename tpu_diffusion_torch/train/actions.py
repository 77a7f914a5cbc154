"""Periodic actions: the port's own copy of `tpu_diffusion/train/actions.py`
(framework-free; the port imports nothing of the JAX package).

`PeriodicCallback(every_steps=..., every_secs=..., on_steps=...)` wraps a
callback and fires it on matching steps/elapsed time. Must be called every
step (enforced, actions.py:59-73); stores the last returned value.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence


class PeriodicAction:
    def __init__(self, *, every_steps: Optional[int] = None,
                 every_secs: Optional[float] = None,
                 on_steps: Optional[Sequence[int]] = None):
        self._every_steps = every_steps
        self._every_secs = every_secs
        self._on_steps = set(on_steps or [])
        self._previous_time = time.monotonic()
        self._last_step: Optional[int] = None

    def should_fire(self, step: int) -> bool:
        """Side-effect-free preview of whether __call__(step) would fire.

        Lets the training loop skip the device->host metric transfer on
        steps where no callback will run (the CUDA stream stays full).
        """
        return self._should_trigger(step)

    def _should_trigger(self, step: int) -> bool:
        if self._every_steps is not None and step % self._every_steps == 0:
            return True
        if (self._every_secs is not None
                and time.monotonic() - self._previous_time
                > self._every_secs):
            return True
        return step in self._on_steps

    def _check_call_every_step(self, step: int):
        if self._last_step is not None and step not in (
                self._last_step, self._last_step + 1):
            raise ValueError(
                f"PeriodicAction must be called every step: got step {step} "
                f"after {self._last_step}")
        self._last_step = step

    def __call__(self, step: int, _fire: Optional[bool] = None,
                 **kwargs) -> bool:
        """`_fire` lets a caller that already previewed `should_fire(step)`
        pass that decision back in, so an every_secs deadline crossing
        between the preview and this call cannot fire with arguments
        prepared for the no-fire path."""
        self._check_call_every_step(step)
        fire = self._should_trigger(step) if _fire is None else _fire
        if not fire:
            return False
        self._previous_time = time.monotonic()
        self._apply(step, **kwargs)
        return True

    def _apply(self, step: int, **kwargs):
        raise NotImplementedError


class PeriodicCallback(PeriodicAction):
    """Fire `callback_fn(step=..., **kwargs)` periodically; keep the last
    result (actions.py:101-163)."""

    def __init__(self, *, callback_fn: Callable,
                 every_steps: Optional[int] = None,
                 every_secs: Optional[float] = None,
                 on_steps: Optional[Sequence[int]] = None,
                 pass_step: bool = True):
        super().__init__(every_steps=every_steps, every_secs=every_secs,
                         on_steps=on_steps)
        self._cb = callback_fn
        self._pass_step = pass_step
        self.last_result = None

    def _apply(self, step: int, **kwargs):
        if self._pass_step:
            self.last_result = self._cb(step=step, **kwargs)
        else:
            self.last_result = self._cb(**kwargs)
