"""The flash forward (`kernels/csrc/flash_attention.cu`) against its bound,
in percent."""

from benchmark.counts.bounds import flash_fwd
from benchmark.harness import roofline_pct

KERNELS = r"\bflash_fwd\w*_kernel"


def read(run):
    return roofline_pct(run, "flash_fwd", flash_fwd, KERNELS)
