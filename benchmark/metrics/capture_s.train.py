"""Seconds the training step took to capture (`StepGraphs` entries'
`capture_s`)."""


def read(run):
    return run.counters.get("capture_s") or None
