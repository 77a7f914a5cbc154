"""A K-step group's encoder pass: the median, over the sampled replays of
the full group's body, of the device ms from its start event to the
"encode" marker inside it."""

from benchmark.program_spans import segment_ms


def read(run):
    return segment_ms(run, "chain", "encode")
