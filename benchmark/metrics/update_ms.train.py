"""The training step's update (clipping, Adam, the EMA): the median, over
the sampled replays of the step, of the device ms from the "backward"
marker to its end event."""

from benchmark.program_spans import segment_ms


def read(run):
    return segment_ms(run, "step", "end")
