"""Seconds from the start of the run to its first timed request."""


def read(run):
    return run.setup_s
