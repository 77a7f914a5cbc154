"""Images of every chain the window completed, per second of the window."""

from benchmark.harness import items_per_s as read  # noqa: F401
