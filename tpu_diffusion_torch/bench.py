"""Samples/s at DDIM-100 on the CIFAR-10 UNet: the twin of the JAX
package's `bench.py`, on graphed chains.

    python -m tpu_diffusion_torch.bench [--device cpu] [--num_channels N]
        [--batch B] [--steps S]

The workload is `bench.py`'s (`bench.py:114-119`): 128 channels,
channel_mult (1,2,2,2), 2 res blocks, attention at 16x16 with 4 heads,
FiLM, bf16 weights and norms (fp32 statistics), batch 64, DDIM-100 from
random weights (seed 0). The chains run through the fused-inference engine
(`models/unet_infer.py`: the fused-QKV attention, GroupNorm and whole
ResBlock kernels) as graphed chains (`sampling/graph.py`): encoder reuse
K=3 is the headline, K=1 (plain DDIM) the companion. Each is captured and
run once, then timed over REPEATS chains: wall time from
the host, device time as the sum of the replays' CUDA-event times, and the
card's idle share, 1 - device / wall.

Prints ONE JSON line with `bench.py`'s keys. `vs_baseline` is the floor
over the measured time, the floor `steps * max(flops / peak_bf16,
min_bytes / peak_hbm)` at the H100's 989 TFLOP/s bf16 and 3.35 TB/s (the
v5e's in `bench.py:62-64`). `min_bytes` is `bench.py:analytic_min_bytes`
counted from the port's own calls: every Conv2d and Linear call of one
full forward of the model reads its input and weights and writes its
output (forward hooks), plus the DDIM update's read and write of x per
step. FLOPs are those calls' products plus the attention's two T x T
products; there is no XLA cost analysis, so the `*_hlo_*` keys are null.
`mfu` divides the chains' own FLOPs (K=3 runs the encoder once a group)
by the measured time. The line also names the attention implementation,
the GroupNorm route and the ResBlock route that engaged, each chain's
median and quartiles, capture seconds and graph pool bytes, and the card.

`--device cpu` runs the same at the width given (the plain PyTorch
versions of the kernels, bodies looped on the host: no device time).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from tpu_diffusion_torch.core.schedules import DDPM
from tpu_diffusion_torch.kernels.groupnorm import gn_route
from tpu_diffusion_torch.kernels.resblock import resblock_route
from tpu_diffusion_torch.models import nn as unet_nn
from tpu_diffusion_torch.models.unet import (AttentionBlock, create_model,
                                             randomize_, resolve_device)
from tpu_diffusion_torch.models.unet_infer import make_fused_apply
from tpu_diffusion_torch.sampling.ancestral import (make_cached_ddim_sampler,
                                                    make_ddim_sampler)
from tpu_diffusion_torch.sampling.graph import GraphCache

METRIC = "cifar10_ddim100_samples_per_sec_per_chip"
# one H100 SXM: dense bf16 tensor-core FLOP/s and HBM bytes/s (data sheet)
H100_BF16_PEAK = 989e12
H100_HBM_BW = 3.35e12
IMAGE = (32, 32, 3)
REUSE = 3    # the headline's encoder reuse (bench.py's default)
REPEATS = 5  # timed chains of each sampler


def bench_model(num_channels: int, device) -> torch.nn.Module:
    """`bench.py`'s UNet at `num_channels`, with the GroupNorm kernel and
    the fused-QKV attention, random weights from seed 0, for inference
    (no parameter needs a gradient)."""
    model = create_model(image_size=32, num_channels=num_channels,
                         num_res_blocks=2, in_channels=3,
                         channel_mult=(1, 2, 2, 2), num_heads=4,
                         attention_resolutions="16",
                         use_scale_shift_norm=True, dtype=torch.bfloat16,
                         attention_impl="fused", norm_impl="fused",
                         device=device)
    return randomize_(model, torch.Generator().manual_seed(0)).eval(
    ).requires_grad_(False)


def forward_cost(model, x: torch.Tensor, t: torch.Tensor, **kw):
    """(min bytes, FLOPs) of one call of `model(x, t, **kw)` by forward
    hooks: each Conv2d / Linear call's input, weights (at the output's
    type) and output bytes, as `bench.py:analytic_min_bytes` counts each
    flax Conv / Dense call, and its products; each attention block's
    4 B T^2 C FLOPs. The first time Dense reads the fp32 sinusoids: the
    JAX layer casts them inside the call, the port before it."""
    total = {"bytes": 0, "flops": 0}

    def conv_hook(module, args, out):
        inp = args[0]
        ksize = math.prod(getattr(module, "kernel_size", (1,)))
        cin = (module.in_channels if hasattr(module, "in_channels")
               else module.in_features)
        features = out.shape[1] if out.ndim == 4 else out.shape[-1]
        itemsize = (4 if module is model.time_dense_0
                    else inp.element_size())
        total["bytes"] += (inp.numel() * itemsize
                           + ksize * cin * features * out.element_size()
                           + out.numel() * out.element_size())
        total["flops"] += 2 * (out.numel() // features) * ksize * cin \
            * features

    def attn_hook(module, args, out):
        b, c, h, w = args[0].shape
        total["flops"] += 4 * b * (h * w) ** 2 * c

    handles = [m.register_forward_hook(conv_hook) for m in model.modules()
               if isinstance(m, (unet_nn.CastConv2d, unet_nn.CastLinear))]
    handles += [m.register_forward_hook(attn_hook) for m in model.modules()
                if isinstance(m, AttentionBlock)]
    try:
        with torch.no_grad():
            model(x, t, **kw)
    finally:
        for h in handles:
            h.remove()
    return total["bytes"], total["flops"]


def routes(model, engine, x: torch.Tensor) -> dict:
    """The attention implementation, GroupNorm route and ResBlock route of
    one forward through the engine ("plain" for a CPU tensor)."""
    gn = set()

    def gn_hook(module, args):
        b, c, h, w = args[0].shape
        gn.add("plain" if not args[0].is_cuda else gn_route(
            b, h * w, c, args[0].element_size(), module.groups,
            torch.cuda.get_device_properties(args[0].device)
            .multi_processor_count)[0])

    handles = [m.register_forward_pre_hook(gn_hook) for m in model.modules()
               if isinstance(m, unet_nn.FusedNormAct)]
    try:
        with torch.no_grad():
            engine(x, torch.zeros(x.shape[0], device=x.device))
    finally:
        for h in handles:
            h.remove()
    res = {}
    for name, d in engine.res_decisions.items():
        if d["impl"] == "kernel":
            side = int(math.isqrt(d["tokens"]))
            res[name] = ("plain" if not x.is_cuda else resblock_route(
                x.shape[0], side, side, d["cin"], d["cout"],
                model.dtype)[0])
    return {"attention_impl": sorted({d["impl"] for d in
                                      model.attn_decisions.values()}),
            "groupnorm_route": sorted(gn),
            "resblock_route": sorted(set(res.values())),
            "resblocks_on_kernel": sorted(res)}


def quartiles(xs) -> dict:
    q1, med, q3 = np.percentile(np.asarray(xs, np.float64), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def time_chains(sample, xT, graphs: GraphCache, repeats: int) -> dict:
    """Wall and device ms of `repeats` chains (after one untimed chain,
    which captures), each chain's device time the sum of its replays', and
    the chain's capture seconds, pool bytes and launches per replay."""
    before = set(graphs.chains)
    sample(xT)
    chain, = (graphs.chains[s] for s in set(graphs.chains) - before)
    sync = torch.cuda.synchronize if xT.is_cuda else (lambda: None)
    wall, device = [], []
    for _ in range(repeats):
        graphs.events = [] if xT.is_cuda else None
        sync()
        t0 = time.perf_counter()
        out = sample(xT)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        if xT.is_cuda:
            device.append(graphs.device_ms())
    graphs.events = None
    res = {"wall_ms": quartiles(wall), "wall_ms_all": wall,
           "finite": bool(torch.isfinite(out).all()),
           "in_range": bool(out.abs().max() <= 1.0),
           "capture_s": sum(chain.capture_s.values()),
           "pool_bytes": sum(chain.pool_bytes.values()),
           # per body (a group of n steps): kernel launches per replay and
           # replays per chain
           "launches_per_replay": {str(len(sig)): n for sig, n in
                                   chain.launches.items()},
           "replays_per_chain": {str(len(sig)): n // (repeats + 1)
                                 for sig, n in chain.replays.items()}}
    if device:
        res["device_ms"] = quartiles(device)
        res["idle_share"] = quartiles([1 - d / w
                                       for d, w in zip(device, wall)])
    return res


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_channels", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=100)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # full fp32 products where fp32 runs (the output conv), as chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = bench_model(args.num_channels, device)
    engine = make_fused_apply(model)
    gen = torch.Generator().manual_seed(1)
    xT = torch.randn((args.batch, *IMAGE), generator=gen).to(device)
    t = torch.zeros(args.batch, device=device)
    fwd_bytes, fwd_flops = forward_cost(model, xT, t)
    _, enc_flops = forward_cost(model, xT, t, mode="encode")
    cache = model(xT, t, mode="encode")
    _, dec_flops = forward_cost(model, xT, t, mode="decode", cache=cache)
    del cache
    engaged = routes(model, engine, xT)

    ddpm = DDPM.create(1000)
    graphs = GraphCache(model)

    def call(xi, i, **kw):
        return engine(xi, i.float() / 1000.0, **kw)

    samplers = {
        REUSE: make_cached_ddim_sampler(
            lambda xi, i: call(xi, i, mode="encode"),
            lambda xi, i, c: call(xi, i, mode="decode", cache=c), ddpm,
            num_steps=args.steps, encoder_reuse=REUSE, graphs=graphs),
        1: make_ddim_sampler(call, ddpm, num_steps=args.steps,
                             graphs=graphs)}
    timed = {k: time_chains(s, xT, graphs, REPEATS)
             for k, s in samplers.items()}

    n_groups = math.ceil(args.steps / REUSE)
    program_flops = enc_flops * n_groups + dec_flops * args.steps
    workload_flops = fwd_flops * args.steps
    ddim_update_bytes = 2 * xT.numel() * 4
    min_bytes_total = (fwd_bytes + ddim_update_bytes) * args.steps
    dt = timed[REUSE]["wall_ms"]["median"] / 1e3
    dt1 = timed[1]["wall_ms"]["median"] / 1e3
    t_floor = max(workload_flops / H100_BF16_PEAK,
                  min_bytes_total / H100_HBM_BW)
    line = {
        "metric": METRIC,
        "value": args.batch / dt,
        "unit": "samples/s/chip",
        "vs_baseline": t_floor / dt,
        "batch": args.batch,
        "ddim_steps": args.steps,
        "mfu": program_flops / dt / H100_BF16_PEAK,
        "encoder_reuse": REUSE,
        "attention_impl": "fused",
        "samples_per_sec_k1": args.batch / dt1,
        "roofline_ratio_hlo": None,
        "workload_gflops": workload_flops / 1e9,
        "program_gflops": program_flops / 1e9,
        "workload_hlo_hbm_gb": None,
        "analytic_min_hbm_gb": min_bytes_total / 1e9,
        "floor_ms": t_floor * 1e3,
        "hlo_roofline_ms": None,
        "measured_ms": dt * 1e3,
        "step_time_ms": dt * 1e3 / args.steps,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "num_channels": args.num_channels,
        "graphed": True,
        "chains": {f"k{k}": v for k, v in timed.items()},
        "routes": engaged,
        "peaks": {"bf16_flops": H100_BF16_PEAK, "hbm_bytes_per_s":
                  H100_HBM_BW},
        "card": card() if device.type == "cuda" else None,
        "note": "value, measured_ms: median wall time of the K=3 chains; "
                "floor and bytes from the port's Conv2d/Linear calls "
                "(bench.py:analytic_min_bytes); no XLA cost analysis: the "
                "*_hlo_* keys are null",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
