"""The share of the traced device time in library convs and GEMMs, in
percent."""

from benchmark.harness import conv_gemm_pct as read  # noqa: F401
