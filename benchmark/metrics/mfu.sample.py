"""The window's FLOPs (the frozen count of its work) per second, as a share
of the bf16 peak, in percent."""

from benchmark.harness import mfu_pct as read  # noqa: F401
