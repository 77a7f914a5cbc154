"""What the SVD's host synchronisations cost the guided protein chain, on
the card.

    python -m tpu_diffusion_torch.protein.sync_probe

The motif conditioner Kabsch-aligns through `torch.linalg.svd`, which
synchronises a CUDA device with the host; this measures whether
`torch.linalg.det` does too and what the guided steps pay for it. It builds
the GVP denoiser at `cli/train_protein.py`'s defaults (112 residues,
(256, 64), 5 conv layers, 250 diffusion steps; random weights from `--seed`,
frozen as `cli/sample_protein.py` freezes them), the synthetic 8-residue
helix motif at guidance scale 1500 and `--batch` chains whose lengths are
drawn from the synthetic dataset, then prints one JSON object:

- `syncs`: synchronising calls of one svd and one det at [batch, 3, 3], of
  one guided step (the guidance at step 10) and of one plain forward, as
  PyTorch's sync debug mode reports them;
- `chain`: one guided reverse chain (conditioner for steps below
  `diffusion_steps // 2`), its wall seconds, and the calls of
  torch.linalg.svd and det in it with the host ms spent in them (waiting
  for the queued forward included);
- `sync_idle`: per guided step and per plain forward, under the profiler,
  the synchronising runtime calls, the card's idle time after them, its
  idle time in all and its busy time;
- `guided_idle_after_syncs_ms`: that idle time over the chain's guided
  steps, and its share of the chain's wall time.

Any other flag goes to `cli/train_protein.py`'s parser (`--max_len`,
`--node_scalars`, ...). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


class TimedLinalg:
    """Count the calls of torch.linalg.svd and det and the host ms spent in
    them (a call that synchronises waits for the device)."""

    def __init__(self, torch):
        self.linalg = torch.linalg
        self.stats = {"svd": [0, 0.0], "det": [0, 0.0]}
        self.real = {n: getattr(torch.linalg, n) for n in self.stats}

    def __enter__(self):
        for name, fn in self.real.items():
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self.stats[_name][0] += 1
                self.stats[_name][1] += (time.perf_counter() - t0) * 1e3
                return out
            setattr(self.linalg, name, timed)
        return self.stats

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.linalg, name, fn)


def count_syncs(torch, fn):
    """Synchronising CUDA calls in one `fn()`, as PyTorch's sync debug mode
    reports them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def sync_idle(torch, fn, steps=3):
    """Where the card waits in `steps` calls of `fn()` under torch.profiler
    (one warm-up call first), per call: the synchronising runtime calls
    (`cuda*Synchronize`, blocking `cudaMemcpy`), the card's idle time from
    each one's return to the next kernel's start (the stream is drained
    when it returns, so that time is idle), the idle time in all between
    the first kernel's start and the last one's end, and the busy time.
    The profiler slows the host's launches, so the idle times are upper
    bounds of the unprofiled ones."""
    import bisect

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.device_type == cuda
                     and not getattr(e, "is_user_annotation", False))
    starts = [k[0] for k in kernels]
    waits = [e.time_range.end for e in prof.events()
             if e.device_type != cuda and ("Synchronize" in e.name
                                           or e.name == "cudaMemcpy")]
    after = [starts[i] - t for t in waits
             for i in [bisect.bisect_left(starts, t)] if i < len(starts)]
    busy, end = 0.0, float("-inf")
    for a, b in kernels:   # the union of the kernels' intervals
        busy += max(b, end) - max(a, end)
        end = max(b, end)
    span = kernels[-1][1] - kernels[0][0]
    return {"syncs_per_call": len(after) / steps,
            "idle_after_syncs_ms_per_call": sum(after) / 1e3 / steps,
            "idle_ms_per_call": (span - busy) / 1e3 / steps,
            "busy_ms_per_call": busy / 1e3 / steps}


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from tpu_diffusion_torch.cli import sample_protein, train_protein
    from tpu_diffusion_torch.protein.conditioner import Structconditioner
    from tpu_diffusion_torch.protein.data import get_protein_data
    from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=1500.0)
    p.add_argument("--seed", type=int, default=0)
    ours, rest = p.parse_known_args(argv)
    args = train_protein.parser().parse_args(rest)
    if not torch.cuda.is_available():
        raise RuntimeError("sync_probe measures a CUDA card; none is here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    b, n_len, steps = ours.batch, args.max_len, args.diffusion_steps
    torch.manual_seed(ours.seed)
    model = train_protein.build_model(args, dev).eval()
    model.requires_grad_(False)
    diffuser = HoogeboomGraphSDE(num_steps=steps, device=dev)
    motif_pos, motif_idx = sample_protein.load_motif(None, None, n_len,
                                                     ours.seed, dev)
    cond = Structconditioner(motif_pos=motif_pos, motif_indices=motif_idx,
                             guidance_scale=ours.guidance_scale)
    ds = get_protein_data("data/scope", max_len=n_len, seed=ours.seed + 1)
    rng = np.random.default_rng(ours.seed)
    lengths = torch.as_tensor(rng.choice(ds.lengths, b), device=dev)
    gen = torch.Generator(device=dev).manual_seed(ours.seed)
    blob = diffuser.sample_blob(gen, b, n_len, lengths=lengths)
    t = torch.full((b,), 10.0 / steps, device=dev)

    def guided():
        return cond.guide(blob, model, 10, diffuser)

    def plain():
        with torch.no_grad():
            return model(blob, t)

    h = torch.randn((b, 3, 3), device=dev)
    syncs = {"svd": count_syncs(torch, lambda: torch.linalg.svd(h)),
             "det": count_syncs(torch, lambda: torch.linalg.det(h)),
             "guided_step": count_syncs(torch, guided),
             "plain_forward": count_syncs(torch, plain)}

    cond_start = steps // 2
    with TimedLinalg(torch) as linalg:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diffuser.reverse_diffusion_sampling(
            gen, blob, model, conditioner=cond, cond_start_step=cond_start)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out.pos).all())

    waits = {"guided_step": sync_idle(torch, guided),
             "plain_forward": sync_idle(torch, plain)}
    idle = waits["guided_step"]["idle_after_syncs_ms_per_call"] * cond_start
    result = {
        "card": smi, "batch": b, "residues": n_len,
        "width": [args.node_scalars, args.node_vectors],
        "conv_layers": args.conv_layers, "diffusion_steps": steps,
        "guided_steps": cond_start, "guidance_scale": ours.guidance_scale,
        "syncs": syncs,
        "chain": {"seconds": chain_s, "finite": finite,
                  "linalg": {k: {"calls": v[0], "host_ms": v[1]}
                             for k, v in linalg.items()}},
        "sync_idle": waits,
        "guided_idle_after_syncs_ms": idle,
        "guided_idle_after_syncs_share": idle / (chain_s * 1e3)}
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    if not finite:
        raise RuntimeError("sync_probe: the guided chain is not finite")
    return result


if __name__ == "__main__":
    main()
