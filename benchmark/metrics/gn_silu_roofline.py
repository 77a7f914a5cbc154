"""The GroupNorm+FiLM+SiLU kernel (`kernels/csrc/groupnorm_silu.cu`)
against its bound, in percent."""

from benchmark.counts.bounds import gn_silu
from benchmark.harness import roofline_pct

KERNELS = r"\b(gn_cluster|gn_stats|gn_apply)_kernel"


def read(run):
    return roofline_pct(run, "gn_silu", gn_silu, KERNELS)
