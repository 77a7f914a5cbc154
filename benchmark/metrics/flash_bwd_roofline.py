"""The flash backward (`kernels/csrc/flash_attention.cu`: its key-block
kernel and the dq gather or conversion) against its bound, in percent."""

from benchmark.counts.bounds import flash_bwd
from benchmark.harness import roofline_pct

KERNELS = r"\bflash_bwd\w*_kernel"


def read(run):
    return roofline_pct(run, "flash_bwd", flash_bwd, KERNELS)
