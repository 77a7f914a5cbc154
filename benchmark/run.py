"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up (imports, CUDA start, the weights and
inputs made from the seed, the cell's captures and warm-ups) is timed from
the start of this module to the first timed request. The window then runs
the cell's requests back to back (one client, closed loop) and closes at
the first request that ends `--seconds` after it opened. `--trace 1` also
records the program's replay events in the window and profiles a few
requests after it, and reports the cell's per-layer metrics instead of its
end-to-end ones. Then the program's state is freed and the plain reference
checks what the window produced; every number compared is printed beside
its limit, as the last lines on standard error and under "checks", last in
the result line. The result is the last line on standard output.

Without a CUDA card, or with fewer than the cell's chips, the run prints no
result and exits 3. `--rehearse` runs the same on the CPU at the tiny sizes
of the configuration's and the traffic's "rehearsal" blocks, for the
tests; its line says platform "cpu".
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402

# build and kernel caches inside the checkout, at fixed paths, so only a
# checkout's first run compiles (the system's nvcc builds go to
# build/tpu_diffusion_torch/ there by themselves)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(harness.ROOT / "build" / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, tiny sizes: for the tests only")
    return p.parse_args(argv)


def fail(code: int, why: str) -> int:
    print(f"benchmark: {why}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload)
    except harness.CellError as e:
        return fail(2, str(e))
    import torch
    imported_s = time.perf_counter() - T0
    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            return fail(3, "torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            return fail(3, f"{torch.cuda.device_count()} card(s), the cell "
                        f"needs {cell.chips}")
        device = torch.device("cuda", 0)
    # full fp32 products wherever fp32 runs, in the system and the
    # reference alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    driver = harness.driver_class(cell.driver)(cell, args.seed, device,
                                               rehearse=args.rehearse)
    driver.setup()
    print(json.dumps({"routes": driver.routes()}), flush=True)
    sync()
    setup_s = time.perf_counter() - T0

    driver.record_events(bool(args.trace))
    units = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        items = driver.unit()
        t1 = time.perf_counter()
        units.append((t0, t1, items))
        if t1 - t_start >= args.seconds:
            break
    run = harness.Run(setup_s=setup_s, t_start=t_start, units=units)
    run.counters = driver.counters()
    attempted = driver.attempted()
    driver.record_events(False)
    if args.trace:
        from benchmark import trace
        run.trace = trace.record(driver.unit, cell.workload["traced_units"])
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = driver.failed()

    chosen = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    got = driver.readings()["system"]  # frees the system's state first
    checks = {k: (got[k], lim) for k, lim in driver.limits.items()}
    times = sorted(u[1] - u[0] for u in units)
    print(json.dumps({"requests": len(units), "attempted": attempted,
                      "request_s": {"min": times[0], "max": times[-1],
                                    "median": times[len(times) // 2]},
                      "window_s": run.window_s, "import_s": imported_s,
                      "setup_s": setup_s,
                      "check_s": time.perf_counter() - t_check}), flush=True)
    del driver
    gc.collect()
    checks["failed_units"] = (failed, 0)
    found = harness.banned_modules()
    if found:
        return fail(4, "modules loaded that the benchmark may not load: "
                    + ", ".join(found))
    correct = all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.wall_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
