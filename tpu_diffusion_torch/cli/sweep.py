"""Sweep tooling: command grid generation + results aggregation.

The port's own copy of `tpu_diffusion/cli/sweep.py` (framework-free), for
the reference's `experiments/create_commands.py` (the `CommandsBuilder`
cartesian-product generator -> commands_eval.txt, :5-86) and
`experiments/read_results.py` (walk experiment dirs, flatten config.yaml +
results.json into a DataFrame, group-by aggregation with mean/std and
Student-t confidence intervals, :14-35).

    python -m tpu_diffusion_torch.cli.sweep gen --out commands.txt \
        --base "python -m tpu_diffusion_torch.cli.main --mode all" \
        --grid conditioning.gamma=1,10,100 --grid training.seed=0,1,2
    python -m tpu_diffusion_torch.cli.sweep agg --logdir logs \
        --groupby conditioning.gamma
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, List, Sequence, Tuple


class CommandsBuilder:
    """Cartesian-product command builder (create_commands.py:5-86)."""

    def __init__(self, base: str):
        self.base = base
        self.grids: List[Tuple[str, Sequence[str]]] = []

    def add(self, key: str, values: Sequence) -> "CommandsBuilder":
        self.grids.append((key, [str(v) for v in values]))
        return self

    def build(self) -> List[str]:
        keys = [k for k, _ in self.grids]
        commands = []
        for combo in itertools.product(*(v for _, v in self.grids)):
            overrides = " ".join(
                f"--override {k}={v}" for k, v in zip(keys, combo))
            commands.append(f"{self.base} {overrides}".strip())
        return commands


def flatten(d: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def collect_results(logdir: str) -> List[Dict]:
    """Walk experiment dirs, join config.yaml with results.json rows
    (read_results.py walk)."""
    import yaml
    rows = []
    for root, _, files in os.walk(logdir):
        if "results.json" not in files:
            continue
        row: Dict = {"dir": root}
        cfg = os.path.join(root, "config.yaml")
        if os.path.exists(cfg):
            with open(cfg) as f:
                row.update(flatten(yaml.safe_load(f) or {}))
        with open(os.path.join(root, "results.json")) as f:
            row.update({f"result.{k}": v
                        for k, v in json.load(f).items()})
        rows.append(row)
    return rows


def aggregate(rows: List[Dict], groupby: List[str],
              confidence: float = 0.95):
    """Group-by mean/std/count + t-interval half-width per result column
    (read_results.py:14-35)."""
    import numpy as np
    import pandas as pd
    from scipy import stats

    df = pd.DataFrame(rows)
    result_cols = [c for c in df.columns if c.startswith("result.")
                   and pd.api.types.is_numeric_dtype(df[c])]
    groupby = [g for g in groupby if g in df.columns]
    if not groupby:
        groupby = ["dir"]

    def t_ci(x):
        x = np.asarray(x.dropna(), float)
        if len(x) < 2:
            return 0.0
        return float(stats.t.ppf((1 + confidence) / 2, len(x) - 1)
                     * x.std(ddof=1) / np.sqrt(len(x)))

    # dropna=False: grids whose cells have heterogeneous config keys
    # (e.g. conditioning.gamma exists only for reconstruction_guidance
    # rows) must keep the rows where a groupby key is absent
    agg = df.groupby(groupby, dropna=False)[result_cols].agg(
        ["mean", "std", "count", t_ci])
    agg.columns = ["_".join(c if isinstance(c, tuple) else (c,))
                   .replace("t_ci", f"ci{int(confidence*100)}")
                   for c in agg.columns]
    return agg.reset_index()


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen")
    g.add_argument("--base", required=True)
    g.add_argument("--grid", action="append", default=[],
                   help="key=v1,v2,v3")
    g.add_argument("--out", default="commands.txt")

    a = sub.add_parser("agg")
    a.add_argument("--logdir", default="logs")
    a.add_argument("--groupby", action="append", default=[])
    a.add_argument("--out", default=None)
    a.add_argument("--confidence", type=float, default=0.95)

    args = p.parse_args(argv)
    if args.cmd == "gen":
        builder = CommandsBuilder(args.base)
        for grid in args.grid:
            key, _, vals = grid.partition("=")
            builder.add(key, vals.split(","))
        commands = builder.build()
        with open(args.out, "w") as f:
            f.write("\n".join(commands) + "\n")
        print(f"[sweep] wrote {len(commands)} commands to {args.out}")
    else:
        rows = collect_results(args.logdir)
        if not rows:
            print(f"[sweep] no results.json under {args.logdir}")
            return
        table = aggregate(rows, args.groupby, args.confidence)
        out = args.out or os.path.join(args.logdir, "aggregated.csv")
        table.to_csv(out, index=False)
        print(table.to_string())
        print(f"[sweep] wrote {out}")


if __name__ == "__main__":
    main()
