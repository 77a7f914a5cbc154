"""The readings that the correctness limits are set from, on the chip at a
cell's own sizes: for each seed, the numbers a run compares for the system
(its timed path, as a run drives it: set-up, then `--units` requests), and
on the control seeds the same numbers for the control, the reference
computed with fp8 operands (`reference/lowp.py`) in the system's place,
and for the faults that the cell's driver plants in the reference put in
the system's place. One JSON line per seed: the driver's `readings`.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--units 2] [--rehearse]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--units", type=int, default=2,
                   help="requests after set-up (the chains checked)")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cpu" if args.rehearse else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        driver = harness.driver_class(cell.driver)(cell, seed, device,
                                                   rehearse=args.rehearse)
        driver.setup()
        for _ in range(args.units):
            driver.unit()
        line = {"cell": cell.name, "seed": seed,
                **driver.readings(seed in controls)}
        print(json.dumps(line), flush=True)
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()
    found = harness.banned_modules()
    if found:
        print("banned modules loaded: " + ", ".join(found), file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
