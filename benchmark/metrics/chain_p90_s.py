"""The 90th percentile of the chains' times, each from its call to its
synchronised result."""

from benchmark.harness import p90_s as read  # noqa: F401
