"""The device ms a sampling step spends in the UNet's transformer blocks:
over the sampled replays of the chain's step, the median ms of each
segment from a block's "transformer.in" marker to its "transformer.out"
marker (`models/ldm_unet.py`), summed over the blocks."""

from benchmark.program_markers import summed_ms


def read(run):
    return summed_ms(run, "chain", "transformer.out")
