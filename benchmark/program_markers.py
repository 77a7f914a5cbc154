"""Sums over the marker segments of the program's span summary
(`program_spans.summary`): a body that marks one kind of block several
times (the latent-diffusion UNet's transformer blocks, each between a
"transformer.in" and a "transformer.out" marker) splits each replay into
many segments of one name. Where the program records no such markers (a
checkout without them, an untraced run), the sum reads None.
"""

from __future__ import annotations

from typing import Optional

from benchmark.program_spans import summary


def summed_ms(run, kind: str, name: str) -> Optional[float]:
    """The sum, over the segments that end at a marker `name`, of their
    median ms over the sampled replays of the longest marked body of
    `kind` ("chain/<steps>" labels), over the body's steps."""
    bodies = [(int(label.split("/")[1]), m) for label, m in
              ((summary(run) or {}).get("markers") or {}).items()
              if label.split("/")[0] == kind]
    if not bodies:
        return None
    n, m = max(bodies, key=lambda b: b[0])
    ms = [v for k, v in zip(m["names"], m["median_ms"]) if k == name]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / n
