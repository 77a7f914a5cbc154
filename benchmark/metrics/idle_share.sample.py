"""The share of the window in which no graph replay ran on the device:
1 - (the replays' CUDA-event seconds) / (the window's seconds), in percent."""

from benchmark.harness import idle_pct as read  # noqa: F401
