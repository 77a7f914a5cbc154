"""The training step's forward: the median, over the sampled replays of
the step, of the device ms from its start event to the "forward" marker
(after the loss)."""

from benchmark.program_spans import segment_ms


def read(run):
    return segment_ms(run, "step", "forward")
