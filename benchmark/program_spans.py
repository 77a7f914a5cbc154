"""The program's own record of the window (`tpu_diffusion_torch/utils/
spans.py`): its host spans, the device intervals of its graph replays and
the markers inside them, asked for once per run and printed as one line
`spans {json}` on standard error.

A cell's `record_events(True)` starts the record by assigning a list to
the graphs' `events` (traced runs only, on the card) and stops it after
the window. Where the program has no such record (a checkout without the
module, the CPU rehearsal, an untraced run), `summary` is None and every
reader of it returns None.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

_ASKED = "program_spans"


def summary(run) -> Optional[dict]:
    """`spans.summary` over the window, from its start to the end of its
    last request: once per run, kept on `run`."""
    if hasattr(run, _ASKED):
        return getattr(run, _ASKED)
    try:
        from tpu_diffusion_torch.utils import spans
    except ImportError:
        got = None
    else:
        got = spans.summary(run.t_start, run.units[-1][1])
    if got is not None:
        print("spans " + json.dumps(got), file=sys.stderr, flush=True)
    setattr(run, _ASKED, got)
    return got


def segment_ms(run, kind: str, name: str, per_step: bool = False
               ) -> Optional[float]:
    """The median ms of the segment that ends at marker `name` (at the end
    event: "end") over the sampled replays of the longest marked body of
    `kind` ("chain/<steps>" or "step/1" labels); with `per_step`, over the
    body's steps."""
    got = summary(run)
    bodies = [(int(label.split("/")[1]), m) for label, m in
              ((got or {}).get("markers") or {}).items()
              if label.split("/")[0] == kind]
    if not bodies:
        return None
    n, m = max(bodies, key=lambda b: b[0])
    if name not in m["names"]:
        return None
    ms = m["median_ms"][m["names"].index(name)]
    if ms is None:
        return None
    return ms / n if per_step else ms
