"""Drive the PyTorch/H100 port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (with the card's name and power limit):
  device   the card, as torch and nvidia-smi name it;
  build    nvcc of every kernel in tpu_diffusion_torch/kernels/csrc/ (in
           parallel) and its seconds;
  kernel   each hand-written kernel against its plain PyTorch version at
           every shape the bench UNet gives it (batch 64, bf16), plus fp32
           cases; time of the kernel, the plain version and one PyTorch
           library call (device time from CUDA-graph replay, and eager
           time from Python), beside the kernel's bound;
  forward  the full-width bench UNet (CIFAR-10, 128 channels, batch 64,
           bf16, random weights from seed 0): eps with the kernels against
           eps with the plain versions, for both norm configurations;
  forward_time  one forward's device time (CUDA graph) and eager time;
  ddim     DDIM-100 with encoder reuse K=3 and plain K=1, both norm
           configurations, each timed twice: samples/s, outputs finite and
           in [-1, 1], the kernels' launch counts equal to what the path
           implies, and every attention block on the fused kernel.
Then the kernel table line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits nonzero before that line.
Needs one CUDA card; imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

BATCH = 64
STEPS = 100
REUSE = 3
REPEATS = 2  # timed chains per configuration (host time varies run to run)
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor-core rate
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
# the JAX bench's model (bench.py:114-119)
BENCH_MODEL = dict(image_size=32, num_channels=128, num_res_blocks=2,
                   in_channels=3, channel_mult=(1, 2, 2, 2), num_heads=4,
                   attention_resolutions="16", use_scale_shift_norm=True)


def card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"torch_name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def emit(card_info, **fields):
    print(json.dumps({**fields, "card": card_info}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=20):
    """(device ms, eager ms) per call. Device: `iters` calls captured in one
    CUDA graph and replayed between CUDA events, so no host launch cost
    hides the card's time. Eager: `iters` back-to-back calls from Python,
    host included, as the sampler pays them. L2 is warm in both, as in the
    UNet, where the producer has just written the input."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, eager


def measure(kernel, plain, library):
    """Device and eager ms of the kernel, its plain version and the
    library call."""
    out = {}
    for prefix, fn in (("", kernel), ("plain_", plain),
                       ("library_", library)):
        out[prefix + "ms"], out[prefix + "eager_ms"] = time_ms(fn)
    return out


def bound_ms(nbytes, ops, op_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def build_models(torch, unet, device, **cfg):
    """(model with kernels, model with plain versions) sharing weights."""
    gen = torch.Generator().manual_seed(SEED)
    kernel_cfg, plain_cfg = cfg["kernel"], cfg["plain"]
    mk = unet.create_model(**BENCH_MODEL, dtype=torch.bfloat16, device=device,
                           **kernel_cfg)
    unet.randomize_(mk, gen)
    mp = unet.create_model(**BENCH_MODEL, dtype=torch.bfloat16, device=device,
                           **plain_cfg)
    mp.load_state_dict(mk.state_dict())
    return mk.eval(), mp.eval()


NORM_CONFIGS = {
    # bench.py's default: plain GroupNorm in bf16 (fp32 statistics)
    "norm_plain_bf16": dict(
        kernel=dict(attention_impl="fused", norm_impl="plain",
                    norm_dtype="bf16"),
        plain=dict(attention_impl="plain", norm_impl="plain",
                   norm_dtype="bf16")),
    # norm_impl="fused": the GroupNorm+FiLM+SiLU kernel; its plain
    # counterpart is GroupNorm32 in fp32, then FiLM and SiLU
    "norm_fused": dict(
        kernel=dict(attention_impl="fused", norm_impl="fused"),
        plain=dict(attention_impl="plain", norm_impl="plain",
                   norm_dtype=None)),
}


def resolve(torch, cfg):
    return {side: {k: (torch.bfloat16 if v == "bf16" else v)
                   for k, v in c.items()} for side, c in cfg.items()}


def capture_shapes(torch, model, x, t, nn_mod, unet):
    """The kernels' call shapes in one full forward: {key: count}."""
    attn, norm = {}, {}
    hooks = []

    def on_qkv(heads):
        def hook(_m, _inp, out):
            key = (tuple(out.shape), heads)
            attn[key] = attn.get(key, 0) + 1
        return hook

    def on_norm(m, args, kwargs, _out):
        x_in = args[0]
        film = (args[1] if len(args) > 1 else kwargs.get("film")) is not None
        key = (tuple(x_in.permute(0, 2, 3, 1).shape), m.groups, film, m.act)
        norm[key] = norm.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, unet.AttentionBlock):
            hooks.append(m.qkv.register_forward_hook(on_qkv(m.heads)))
        if isinstance(m, nn_mod.FusedNormAct):
            hooks.append(m.register_forward_hook(on_norm, with_kwargs=True))
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return attn, norm


def kernel_phase(torch, F, card_info, attn_shapes, norm_shapes):
    """Each kernel against its plain version at the path's shapes; returns
    {kernel: per-forward sums}."""
    from tpu_diffusion_torch.kernels import attention, groupnorm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    totals = {}

    def add(name, count, err, times, bnd, by):
        t = totals.setdefault(name, dict(max_abs_err=0.0, bound_ms=0.0,
                                         by={}))
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["bound_ms"] += count * bnd
        for k, v in times.items():
            t[k] = t.get(k, 0.0) + count * v
        t["by"][by] = t["by"].get(by, 0.0) + count * bnd

    # bf16 output rounding (2^-8 relative) on both sides, and the plain
    # version's bf16 rounding of p; fp32: summation order only
    attn_tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    cases = [(shape, heads, torch.bfloat16, count)
             for (shape, heads), count in sorted(attn_shapes.items())]
    cases += [((4, 256, 768), 4, torch.float32, 0),
              ((4, 100, 384), 2, torch.float32, 0)]
    for (b, t, c3), heads, dtype, count in cases:
        c, d = c3 // 3, c3 // 3 // heads
        qkv = torch.randn((b, t, c3), generator=gen, device=dev).to(dtype)
        got = attention.flash_attention_fused(qkv, heads)
        want = attention.fused_attention_ref(qkv, heads)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= attn_tol[dtype],
              f"attention {b, t, c3} {dtype}: max abs err {err}")
        q, k, v = (qkv.view(b, t, 3, heads, d)[:, :, s].transpose(1, 2)
                   .contiguous() for s in range(3))
        times = measure(
            lambda: attention.flash_attention_fused(qkv, heads),
            lambda: attention.fused_attention_ref(qkv, heads),
            lambda: F.scaled_dot_product_attention(q, k, v))
        isz = qkv.element_size()
        bnd, by = bound_ms(b * t * 4 * c * isz, 4 * b * heads * t * t * d,
                           BF16_FLOPS if dtype == torch.bfloat16
                           else FP32_FLOPS)
        emit(card_info, phase="kernel", kernel="flash_attention_fused",
             shape=[b, t, c3], heads=heads, dtype=str(dtype),
             count_per_forward=count, max_abs_err=err, tol=attn_tol[dtype],
             **times, bound_ms=bnd, bound_by=by)
        if count:
            add("flash_attention_fused", count, err, times, bnd, by)

    # fp32 statistics on both sides; bf16: one output rounding of values
    # up to ~5 (2^-8 relative)
    gn_tol = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
    cases = [(shape, groups, film, act, torch.bfloat16, count)
             for (shape, groups, film, act), count
             in sorted(norm_shapes.items())]
    cases += [((4, 32, 32, 128), 32, True, "silu", torch.float32, 0),
              ((4, 4, 4, 512), 32, False, "none", torch.float32, 0)]
    for (b, h, w, c), groups, film, act, dtype, count in cases:
        x = (torch.randn((b, h, w, c), generator=gen, device=dev) * 2
             + 0.5).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        scale = shift = None
        if film:
            emb = (0.2 * torch.randn((b, 2 * c), generator=gen, device=dev)
                   ).to(dtype)
            scale, shift = emb[:, :c], emb[:, c:]
        args = (x, gamma, beta, scale, shift, groups, 1e-5, act)
        got = groupnorm.fused_groupnorm_silu(*args)
        want = groupnorm.reference_groupnorm_silu(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= gn_tol[dtype],
              f"groupnorm {b, h, w, c} {dtype} film={film}: max abs err "
              f"{err}")
        xn = x.permute(0, 3, 1, 2).contiguous()
        g16, b16 = gamma.to(dtype), beta.to(dtype)

        def library():
            y = F.group_norm(xn, groups, g16, b16, 1e-5)
            if film:
                y = y * (1 + scale[:, :, None, None]) + shift[:, :, None, None]
            return F.silu(y) if act == "silu" else y

        times = measure(lambda: groupnorm.fused_groupnorm_silu(*args),
                        lambda: groupnorm.reference_groupnorm_silu(*args),
                        library)
        n = b * h * w * c
        isz = x.element_size()
        nbytes = 2 * n * isz + 2 * c * 4 + (2 * b * c * isz if film else 0)
        # ~8 fp32 operations per element: 3 for the sums, 1 fma, 4 for SiLU
        bnd, by = bound_ms(nbytes, 8 * n, FP32_FLOPS)
        emit(card_info, phase="kernel", kernel="fused_groupnorm_silu",
             shape=[b, h, w, c], groups=groups, film=film, act=act,
             dtype=str(dtype), count_per_forward=count, max_abs_err=err,
             tol=gn_tol[dtype], **times, bound_ms=bnd, bound_by=by)
        if count:
            add("fused_groupnorm_silu", count, err, times, bnd, by)
    return totals


def expected_counts(model, nn_mod, unet):
    """Kernel calls per encode pass and per decode pass of the model."""
    per = {"attention": [0, 0], "groupnorm": [0, 0]}
    for name, m in model.named_modules():
        enc = name.startswith(("enc_", "down_"))
        if isinstance(m, unet.AttentionBlock):
            per["attention"][0 if enc else 1] += 1
        if isinstance(m, nn_mod.FusedNormAct):
            per["groupnorm"][0 if enc else 1] += 1
    return per


def ddim_run(torch, unet, nn_mod, attention, groupnorm, card_info, samplers,
             model, name, k, repeat, xT):
    """One timed DDIM-100 chain; checks its output, its kernel launch counts
    and its attention decisions."""
    model.attn_decisions.clear()
    per = expected_counts(model, nn_mod, unet)
    n_enc = math.ceil(STEPS / k)
    a0, g0 = attention.launches, groupnorm.launches
    sample = samplers(model, STEPS)[k]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    out = sample(xT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - s0
    want_a = n_enc * per["attention"][0] + STEPS * per["attention"][1]
    want_g = n_enc * per["groupnorm"][0] + STEPS * per["groupnorm"][1]
    got_a = attention.launches - a0
    got_g = groupnorm.launches - g0
    emit(card_info, phase="ddim", config=name, encoder_reuse=k,
         repeat=repeat, batch=BATCH, steps=STEPS, seconds=seconds,
         samples_per_s=BATCH / seconds, ms_per_step=seconds * 1e3 / STEPS,
         attention_launches=got_a, attention_expected=want_a,
         groupnorm_launches=got_g, groupnorm_expected=want_g,
         out_min=out.min().item(), out_max=out.max().item(),
         out_std=out.float().std().item())
    check(bool(torch.isfinite(out).all()) and out.abs().max() <= 1.0
          and out.shape == xT.shape, f"ddim {name} K={k}: bad output")
    check(got_a == want_a and got_a > 0,
          f"ddim {name} K={k}: {got_a} attention launches, want {want_a}")
    check(got_g == want_g,
          f"ddim {name} K={k}: {got_g} groupnorm launches, want {want_g}")
    check(sorted(model.attn_decisions)
          == sorted(n for n, m in model.named_modules()
                    if isinstance(m, unet.AttentionBlock))
          and all(d["impl"] == "fused"
                  for d in model.attn_decisions.values()),
          f"ddim {name} K={k}: attention decisions {model.attn_decisions}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from tpu_diffusion_torch import (DDPM, make_cached_ddim_sampler,
                                     make_ddim_sampler)
    from tpu_diffusion_torch.kernels import attention, build, groupnorm
    from tpu_diffusion_torch.models import nn as nn_mod
    from tpu_diffusion_torch.models import unet

    # fp32 products in full fp32: the fp32 kernel checks compare exactly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_info = card()
    emit(card_info, phase="device", count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = build.build_all()
    emit(card_info, phase="build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "ptxas": [ln for ln in v["ptxas"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen).to(dev)
    t = torch.full((BATCH,), 0.5, device=dev)

    models = {name: build_models(torch, unet, dev, **resolve(torch, cfg))
              for name, cfg in NORM_CONFIGS.items()}
    attn_shapes, norm_shapes = capture_shapes(
        torch, models["norm_fused"][0], x, t, nn_mod, unet)
    totals = kernel_phase(torch, F, card_info, attn_shapes, norm_shapes)

    # --- full-width forward: kernels against plain versions ------------
    for name, (mk, mp) in models.items():
        with torch.no_grad():
            got, want = mk(x, t), mp(x, t)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        scale = want.abs()
        ok = (bool(torch.isfinite(got).all())
              and diff.max() <= 1e-1 * scale.max()
              and diff.mean() <= 3e-2 * scale.mean())
        emit(card_info, phase="forward", config=name, shape=list(got.shape),
             max_abs_diff=diff.max().item(), mean_abs_diff=diff.mean().item(),
             max_abs_eps=scale.max().item(), mean_abs_eps=scale.mean().item(),
             tol="max <= 0.1 * max|eps|, mean <= 0.03 * mean|eps|: bf16 "
                 "end to end, and the plain norm chain rounds to bf16 after "
                 "the norm, the FiLM and the SiLU where the kernel rounds "
                 "once (1.2% of mean|eps| on the CPU at width 32); a wrong "
                 "group, head or FiLM term moves eps by O(1)")
        check(ok, f"forward {name}: kernels disagree with plain versions")
        check(all(d["impl"] == "fused" for d in mk.attn_decisions.values())
              and len(mk.attn_decisions) == 6,
              f"attention decisions {mk.attn_decisions}")

        def forward(model=mk):
            with torch.no_grad():
                return model(x, t)

        device_ms, eager_ms = time_ms(forward, iters=5)
        emit(card_info, phase="forward_time", config=name, batch=BATCH,
             device_ms=device_ms, eager_ms=eager_ms,
             device_idle_share=1 - device_ms / eager_ms,
             note="device: one full forward replayed from a CUDA graph; "
                  "eager: the same forward launched from Python")

    # --- DDIM-100: the main path ---------------------------------------
    ddpm = DDPM.create(1000)
    xT = torch.randn((BATCH, 32, 32, 3), generator=gen).to(dev)

    def samplers(model, steps):
        def call(xi, i, **kw):
            return model(xi, i.float() / 1000.0, **kw)
        return {
            REUSE: make_cached_ddim_sampler(
                lambda xi, i: call(xi, i, mode="encode"),
                lambda xi, i, c: call(xi, i, mode="decode", cache=c),
                ddpm, num_steps=steps, encoder_reuse=REUSE),
            1: make_ddim_sampler(call, ddpm, num_steps=steps)}

    runs = [(name, k) for name in models for k in (REUSE, 1)]
    for name, k in runs:  # warm-up, not counted
        samplers(models[name][0], 2 * REUSE)[k](xT)
    torch.cuda.synchronize()
    attention.launches = 0
    groupnorm.launches = 0
    for name, k in runs:
        for repeat in range(REPEATS):
            ddim_run(torch, unet, nn_mod, attention, groupnorm, card_info,
                     samplers, models[name][0], name, k, repeat, xT)
    counts = {"flash_attention_fused": attention.launches,
              "fused_groupnorm_silu": groupnorm.launches}
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")

    meta = {
        "flash_attention_fused": (
            "tpu_diffusion_torch/kernels/csrc/attention_fused.cu",
            "tpu_diffusion/kernels/attention.py:362"),
        "fused_groupnorm_silu": (
            "tpu_diffusion_torch/kernels/csrc/groupnorm_silu.cu",
            "tpu_diffusion/kernels/groupnorm.py:82"),
    }
    table = []
    for name, (source, replaces) in meta.items():
        tot = totals[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": max(tot["by"], key=tot["by"].get),
            "library_ms": tot["library_ms"],
            "eager_ms": tot["eager_ms"],
            "plain_eager_ms": tot["plain_eager_ms"],
            "library_eager_ms": tot["library_eager_ms"],
            "per": "one full UNet forward at batch 64 (sum over its call "
                   "shapes); ms: device time (CUDA-graph replay), eager_ms: "
                   "launched from Python; launches: the four DDIM-100 runs"})
    print(json.dumps({"kernels": table}), flush=True)
    print(card_info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
