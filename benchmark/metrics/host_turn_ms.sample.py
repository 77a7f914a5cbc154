"""The host's turn between chains: the median, over consecutive chains of
the window, of the device ms from a chain's last replay's end to the next
chain's first replay's start (the program's replay events,
`utils/spans.py`)."""

from benchmark.program_spans import summary


def read(run):
    turn = ((summary(run) or {}).get("turns") or {}).get("chain")
    return turn["median_ms"] if turn else None
