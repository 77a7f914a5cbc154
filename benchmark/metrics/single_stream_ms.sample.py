"""The device ms a sampling step spends in FLUX's single-stream blocks:
over the sampled replays of the chain's step, the median ms of each
segment from a block's "flux.single.in" marker to its "flux.single.out"
marker (`models/flux.py`), summed over the blocks."""

from benchmark.program_markers import summed_ms


def read(run):
    return summed_ms(run, "chain", "flux.single.out")
