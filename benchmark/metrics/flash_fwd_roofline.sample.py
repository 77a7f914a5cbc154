"""The flash self-attention forward at the sampling cells' shapes (its
"wgmma" and "mma" routes in `kernels/csrc/flash_attention.cu`) against its
bound (`counts/bounds.py:flash_fwd`), in percent."""

from benchmark.counts.bounds import flash_fwd
from benchmark.harness import roofline_pct

KERNELS = r"\bflash_fwd_(tma|mma)_kernel"


def read(run):
    return roofline_pct(run, "flash_fwd", flash_fwd, KERNELS)
