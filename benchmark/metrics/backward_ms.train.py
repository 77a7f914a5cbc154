"""The training step's backward: the median, over the sampled replays of
the step, of the device ms from the "forward" marker to the "backward"
marker (after `loss.backward()`)."""

from benchmark.program_spans import segment_ms


def read(run):
    return segment_ms(run, "step", "backward")
