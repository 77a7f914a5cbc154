"""Seconds the chain's bodies took to capture (`Chain.capture_s`)."""


def read(run):
    return run.counters.get("capture_s") or None
