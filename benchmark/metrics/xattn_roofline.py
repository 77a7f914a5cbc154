"""The cross-attention kernel (`flash_xattn_fwd_kernel` in
`kernels/csrc/flash_attention.cu`) against its bound
(`counts/xattn_bounds.py`), in percent."""

from benchmark.counts.xattn_bounds import xattn
from benchmark.harness import roofline_pct

KERNELS = r"\bflash_xattn_fwd_kernel"


def read(run):
    return roofline_pct(run, "xattn", xattn, KERNELS)
