"""The whole-ResBlock kernel (`kernels/csrc/resblock.cu`) against its
bound, in percent: the bounds of the traced chains' calls over the device
seconds of its kernels."""

from benchmark.counts.bounds import resblock
from benchmark.harness import roofline_pct

KERNELS = r"\b(gn_partial|gn_act|conv3x3_wgmma|conv3x3)_kernel"


def read(run):
    return roofline_pct(run, "resblock", resblock, KERNELS)
