"""What the benchmark finds by name: the cells, configurations, traffic
mixes, drivers and metric readers, all files under `benchmark/`.

`BENCHMARK.json` at the checkout's root lists the configurations, cells
and metrics. A configuration `c` is `benchmark/configs/<c>.json`, a traffic
mix `m` is `benchmark/traffic/<m>.json` (it names its driver kind `k`,
`benchmark/drivers/<k>.py`), a cell `w` is `benchmark/workloads/<w>.json`
(its correctness limits and how much of its work the traced run profiles),
and a metric `x` is read by `benchmark/metrics/<x>.py`'s `read(run)`. A
missing file refuses the cell before anything runs.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no process of the benchmark may load
BANNED = frozenset({"jax", "jaxlib", "flax", "optax", "tpu_diffusion"})


class CellError(Exception):
    """A cell, or a file it needs, is missing or malformed."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing file: {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise CellError(f"cell {name!r} names a configuration "
                        f"{entry['config']!r} that BENCHMARK.json lacks")
    here = root / "benchmark"
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    if not (here / "drivers" / f"{traffic.get('driver')}.py").is_file():
        raise CellError(f"traffic {entry['traffic']!r} names a driver "
                        f"{traffic.get('driver')!r} that has no file")

    def applies(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    layer = [m for m in bench["per_layer"] if applies(m)]
    for m in e2e + layer:
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            raise CellError(f"metric {m['name']!r} has no reader file")
    return Cell(name=name, chips=entry["chips"],
                config=_json(root / conf["file"]), traffic=traffic,
                workload=_json(here / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def driver_class(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`read(run)` of `benchmark/metrics/<metric>.py` (a name may hold
    dots, so the file is loaded by its path)."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What one run hands the metric readers. `units` are the window's
    requests as (start s, end s, items) on the host clock, `t_start` the
    window's start; `counters` the driver's readings of the program's own
    counters after the window; `trace` the profiled stretch (traced runs
    only)."""
    setup_s: float
    t_start: float
    units: List[tuple]
    counters: Dict[str, object] = field(default_factory=dict)
    trace: Optional[object] = None

    @property
    def window_s(self) -> float:
        return self.units[-1][1] - self.t_start

    @property
    def items(self) -> int:
        return sum(u[2] for u in self.units)


def items_per_s(run: Run) -> float:
    """Items of every completed request over the window, from its start to
    the end of its last request."""
    return run.items / run.window_s


def p90_s(run: Run) -> float:
    """The 90th percentile of the requests' times."""
    return statistics.quantiles([u[1] - u[0] for u in run.units], n=10,
                                method="inclusive")[-1]


def idle_pct(run: Run) -> Optional[float]:
    """100 (1 - device / wall): the device seconds the program's replays
    recorded in the window, over the window."""
    dev = run.counters.get("replay_device_s")
    if not dev:
        return None
    return 100.0 * (1.0 - dev / run.window_s)


def mfu_pct(run: Run) -> Optional[float]:
    """The window's work in FLOPs (the frozen count a unit of work needs)
    over its length and the bf16 peak, in percent."""
    from benchmark.counts.bounds import BF16_FLOPS
    per_item = run.counters.get("flops_per_item")
    if not per_item:
        return None
    return 100.0 * per_item * run.items / run.window_s / BF16_FLOPS


def roofline_pct(run: Run, kernel: str, bound_fn: Callable,
                 pattern: str) -> Optional[float]:
    """100 x (the bounds of a unit's calls of `kernel`, times the traced
    units) / (the device seconds of the operations matching `pattern`)."""
    calls = run.counters.get("kernel_calls", {}).get(kernel)
    if run.trace is None or not calls:
        return None
    seconds = run.trace.seconds_of(pattern)
    if seconds <= 0:
        return None
    bound = sum(bound_fn(*c) for c in calls) * run.trace.units
    return 100.0 * bound / seconds


# the system's own kernels (tpu_diffusion_torch/kernels/csrc), by source
OWN_KERNELS = (r"\b(attention_fused\w*|flash_\w+|gn_\w+|conv3x3\w*)_kernel")
LIBRARY_CONV_GEMM = (r"gemm|conv|xmma|cutlass|cudnn|fprop|dgrad|wgrad"
                     r"|sm90_|sm80_")


def conv_gemm_pct(run: Run) -> Optional[float]:
    """The share of the traced device time in library convs and GEMMs
    (cuDNN, cuBLAS, CUTLASS kernels by name), the system's own kernels left
    out."""
    if run.trace is None:
        return None
    own, lib = re.compile(OWN_KERNELS), re.compile(LIBRARY_CONV_GEMM)
    total = lib_s = 0.0
    for n, s, e in run.trace.device:
        total += e - s
        if lib.search(n) and not own.search(n):
            lib_s += e - s
    return 100.0 * lib_s / total if total else None


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one of BANNED."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)
