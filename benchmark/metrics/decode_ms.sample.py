"""One decoder pass with its DDIM update: the median, over the sampled
replays of the full group's body, of the device ms from the "encode"
marker to its end event, over the group's steps."""

from benchmark.program_spans import segment_ms


def read(run):
    return segment_ms(run, "chain", "end", per_step=True)
