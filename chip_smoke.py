"""Drive the PyTorch/H100 port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (with the card's name and power limit):
  device   the card, as torch and nvidia-smi name it;
  build    nvcc of every kernel in tpu_diffusion_torch/kernels/csrc/ (in
           parallel) and its seconds.
The DDIM path of the CIFAR-10 bench UNet:
  kernel   the fused-QKV attention and GroupNorm+FiLM+SiLU kernels against
           their plain PyTorch versions at every shape the bench UNet gives
           them (batch 64, bf16), plus fp32 cases and, for the attention
           kernel in bf16, T=16, an uneven T, T=1024 (its key ring refilled),
           d=32 and d=128; time of the kernel, the plain version and one
           PyTorch library call (device time from CUDA-graph replay, and
           eager time from Python; for attention also SDPA with the layout
           copies a library route would pay), beside the kernel's bound;
  forward  the full-width bench UNet (CIFAR-10, 128 channels, batch 64,
           bf16, random weights from seed 0): eps with the kernels against
           eps with the plain versions, for both norm configurations;
  forward_time  one forward's device time (CUDA graph) and eager time;
  ddim     DDIM-100 with encoder reuse K=3 and plain K=1, both norm
           configurations, each timed twice: samples/s, outputs finite and
           in [-1, 1], the kernels' launch counts equal to what the path
           implies, and every attention block on the fused kernel.
The fused-inference engine (`models/unet_infer.py`) on the same UNet:
  resblock_kernel  the whole-ResBlock kernel against its plain version at
           the five shapes the engine gives it (batch 64, bf16), plus an
           fp32, an additive-mode and an identity-skip case; times as in
           `kernel`, with the port's own `ResBlock` module (cuDNN convs; the
           eager norm chain, and the GN kernel) as the library yardstick;
  engine_forward  eps through the engine (its five 32x32 ResBlocks on the
           kernel) against eps of the plain model, both norm
           configurations, with the engine's decision log; one forward's
           device and eager time beside the model's own;
  engine_ddim  DDIM-100 through the engine, K=3 and K=1: samples/s, outputs
           finite and in [-1, 1], and the ResBlock kernel's launch count
           equal to what the path implies (368 and 500).
The conditional path of `tpu_diffusion_torch.cli.main --mode eval` on the
64px flowers UNet (128 channels, channel_mult (1,2,3,4), 2 res blocks,
64-channel heads, attention at 32/16/8, FiLM, bf16 weights, fp32 norms,
batch 32, random weights from seed 0):
  cond_forward  eps with attention_impl="auto" (the flash kernels at T=1024,
           dense einsums below) against eps with "dense" everywhere, for
           the amortized (6 input channels) and unconditional (3) models,
           with the attention decision log; one forward's device and eager
           time;
  flash_kernel  the flash forward (o, lse) and backward (dq, dk, dv)
           kernels against their plain versions at the path's shape
           [128, 1024, 64] bf16, fp32 cases, and in bf16 an uneven T, one
           tile (T=64), d=32 and d=128; whether two backward calls on the
           same inputs agree bitwise (dq is summed with atomics); times as
           in `kernel`, SDPA forward and its autograd backward as the
           library yardstick;
  guidance_grad  the reconstruction-guidance gradient w.r.t. x_i through
           the whole UNet with the kernels against the plain versions;
  sample   amortized inpainting over 1000 steps with encoder reuse K=3 and
           K=1 (K=1 equal to the plain amortized sampler), reconstruction
           guidance (gamma 10, every step guided) and outpainting
           replacement on a 50-step chain (cut from 1000 to keep the run
           short), and the rejected hyperresolution replacement; samples/s,
           MSE/PSNR/SSIM against the (synthetic) test images (random
           weights: no quality claim), outputs finite and in [-1, 1], and
           the flash kernels' launch counts equal to what the path implies.
DDPM training of `tpu_diffusion_torch.cli.main --mode train` on the same
64px configuration (flowers,inpainting,amortized; fp32 parameters, bf16
forward, batch 32, synthetic images):
  train    20 steps through the cli's own functions (`build`, `init_state`,
           `make_loss`, the trainer): ms per step after the first, loss and
           gradient norm finite at every step, parameters and EMA
           parameters moved, 5 flash forward and 5 flash backward launches
           per step, a checkpoint written and read back equal, then
           `cli.main --mode eval` from that checkpoint on a 50-step chain.
Then the kernel table line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits nonzero before that line.
Needs one CUDA card; imports nothing of JAX.

    python3 chip_smoke.py --kernels

builds the kernels and runs only the attention kernels' cases of the
`kernel` and `flash_kernel` phases, at the shapes the two paths give them
(a quick check while working on a kernel; it does not print the ok line).
"""

import copy
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
# what the two paths give the attention kernels per forward (checked against
# the models' own calls in the full run): {call shape: calls}
ATTN_PATH_SHAPES = {((BATCH, 256, 768), 4): 5, ((BATCH, 16, 768), 4): 1}
FLASH_PATH_SHAPES = {(128, 1024, 64): 5}


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
        plain=dict(attention_impl="dense", norm_impl="plain",
                   norm_dtype="bf16")),
    # norm_impl="fused": the GroupNorm+FiLM+SiLU kernel; its plain
    # counterpart is GroupNorm32 in fp32, then FiLM and SiLU
    "norm_fused": dict(
        kernel=dict(attention_impl="fused", norm_impl="fused"),
        plain=dict(attention_impl="dense", norm_impl="plain",
                   norm_dtype=None)),
}


def resolve(torch, cfg):
    return {side: {k: (torch.bfloat16 if v == "bf16" else v)
                   for k, v in c.items()} for side, c in cfg.items()}


def capture_shapes(torch, model, x, t, nn_mod, unet):
    """The kernels' call shapes in one full forward: {key: count}, for the
    attention and norm kernels and for the ResBlocks (input shape, output
    channels, 1x1 skip)."""
    attn, norm, res = {}, {}, {}
    hooks = []

    def on_res(m, args, _out):
        key = (tuple(args[0].permute(0, 2, 3, 1).shape), m.cout,
               m.skip is not None)
        res[key] = res.get(key, 0) + 1

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
        if isinstance(m, unet.ResBlock):
            hooks.append(m.register_forward_hook(on_res))
    try:
        with torch.no_grad():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return attn, norm, res


def resblock_bound(b, h, w, cin, cout, skip, itemsize, op_rate):
    """The bound of one `fused_resblock` call: read x and the weights, write
    the output, each once; the operations of its two 3x3 convs and the 1x1
    skip (tpu_diffusion/kernels/resblock.py:292)."""
    weights = 9 * cin * cout + 9 * cout * cout + (cin * cout if skip else 0)
    nbytes = itemsize * (b * h * w * (cin + cout) + weights)
    return bound_ms(nbytes, 2 * b * h * w * weights, op_rate)


def resblock_inputs(torch, gen, dev, b, hw, cin, cout, film, skip, dtype):
    """Arguments of `fused_resblock`: x ~ N(0.3, 1.5^2), conv weights
    ~ N(0, 1 / fan_in), norm scales 1 + N(0, 0.1^2), FiLM 1 + N(0, 0.2^2)."""
    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    args = [(rand(b, hw, hw, cin) * 1.5 + 0.3).to(dtype),
            1 + rand(cin, scale=0.1), rand(cin, scale=0.1),
            rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(dtype),
            rand(cout, scale=0.1), 1 + rand(cout, scale=0.1),
            rand(cout, scale=0.1),
            1 + rand(b, cout, scale=0.2) if film else None,
            rand(b, cout, scale=0.2),
            rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5).to(dtype),
            rand(cout, scale=0.1), None, None]
    if skip:
        args[11:] = [rand(cin, cout, scale=cin ** -0.5).to(dtype),
                     rand(cout, scale=0.1)]
    return args


def resblock_phase(torch, card_info, res_shapes, unet, dev, min_tokens=1024):
    """`fused_resblock` against `resblock_reference` at the shapes the engine
    gives it, plus an fp32, an additive-mode and an identity-skip case;
    returns {kernel: per-forward sums}."""
    from tpu_diffusion_torch.kernels import resblock
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(shape[0], shape[1], shape[3], cout, True, skip, bf16, count)
             for (shape, cout, skip), count in sorted(res_shapes.items())
             if shape[1] * shape[2] >= min_tokens]
    cases += [(8, 32, 128, 128, True, False, fp32, 0),
              (8, 32, 256, 128, False, True, bf16, 0),   # additive mode
              (8, 16, 256, 256, True, False, bf16, 0)]   # identity skip
    tot = dict(max_abs_err=0.0, bound_ms=0.0, by={})
    for b, hw, cin, cout, film, skip, dtype, count in cases:
        args = resblock_inputs(torch, gen, dev, b, hw, cin, cout, film, skip,
                               dtype)
        got = resblock.fused_resblock(*args)
        want = resblock.resblock_reference(*args)
        torch.cuda.synchronize()
        ref_max = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        # fp32: the order of the sums through two convs and two norms. bf16:
        # the kernel rounds conv1's output to bf16 before GN2 where the
        # plain version keeps it fp32 (2^-9 relative per element, averaged
        # out by conv2's sum over 9 * Cout terms), and each side rounds its
        # output once: a bf16 ulp, at most 2^-8 of the largest entry
        tol = (2e-5 if dtype == fp32 else 1e-2) * ref_max
        check(math.isfinite(err) and err <= tol,
              f"resblock {b, hw, cin, cout} {dtype} film={film} skip={skip}: "
              f"max abs err {err}, tol {tol}")
        # the library yardstick: the port's own ResBlock module on the same
        # input (cuDNN convs; it also runs the small emb projection)
        emb = torch.randn((b, 512), generator=gen, device=dev).to(dtype)
        xn = args[0].permute(0, 3, 1, 2)
        blocks = {impl: unet.ResBlock(
            cin, cout, 512, film, dtype=dtype, device=dev, norm_impl=impl,
            norm_dtype=dtype if impl == "plain" else None).eval()
            for impl in ("plain", "fused")}

        def module(impl):
            def run():
                with torch.no_grad():
                    return blocks[impl](xn, emb)
            return run

        times = measure(lambda: resblock.fused_resblock(*args),
                        lambda: resblock.resblock_reference(*args),
                        module("plain"))
        gn_ms, gn_eager = time_ms(module("fused"))
        bnd, by = resblock_bound(b, hw, hw, cin, cout, skip,
                                 args[0].element_size(),
                                 BF16_FLOPS if dtype == bf16 else FP32_FLOPS)
        emit(card_info, phase="resblock_kernel", kernel="fused_resblock",
             shape=[b, hw, hw, cin], cout=cout, film=film, skip_conv=skip,
             dtype=str(dtype), count_per_forward=count, max_abs_err=err,
             max_abs_ref=ref_max, tol=tol, **times,
             library_gn_kernel_ms=gn_ms, library_gn_kernel_eager_ms=gn_eager,
             bound_ms=bnd, bound_by=by,
             library="the port's ResBlock module: cuDNN convs with the "
                     "eager bf16 norm chain (library_ms) or the GN kernel "
                     "(library_gn_kernel_ms)")
        if count:
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_ms"] += count * bnd
            tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
            for k, v in {**times, "library_gn_kernel_ms": gn_ms}.items():
                tot[k] = tot.get(k, 0.0) + count * v
    return {"fused_resblock": tot}


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
              ((4, 100, 384), 2, torch.float32, 0),
              # bf16, off the path: one partly filled tile, an uneven T, the
              # ring refilled (T > 256), d = 32, d = 128 (two slots, uneven)
              ((4, 16, 768), 4, torch.bfloat16, 0),
              ((4, 100, 768), 4, torch.bfloat16, 0),
              ((8, 1024, 768), 4, torch.bfloat16, 0),
              ((4, 256, 384), 4, torch.bfloat16, 0),
              ((4, 256, 1536), 4, torch.bfloat16, 0),
              ((4, 300, 1536), 4, torch.bfloat16, 0)]
    for (b, t, c3), heads, dtype, count in cases:
        c, d = c3 // 3, c3 // 3 // heads
        qkv = torch.randn((b, t, c3), generator=gen, device=dev).to(dtype)
        got = attention.flash_attention_fused(qkv, heads)
        want = attention.dense_attention(qkv, heads)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= attn_tol[dtype],
              f"attention {b, t, c3} {dtype}: max abs err {err}")
        q, k, v = (qkv.view(b, t, 3, heads, d)[:, :, s].transpose(1, 2)
                   .contiguous() for s in range(3))
        times = measure(
            lambda: attention.flash_attention_fused(qkv, heads),
            lambda: attention.dense_attention(qkv, heads),
            lambda: F.scaled_dot_product_attention(q, k, v))

        def library_with_layout():
            # what a library route would pay on this layout: three copies
            # to [B, H, T, d], SDPA, one copy back to [B, T, C]
            q_, k_, v_ = (x.contiguous() for x in qkv.view(
                b, t, 3, heads, d).permute(2, 0, 3, 1, 4))
            return F.scaled_dot_product_attention(q_, k_, v_).transpose(
                1, 2).reshape(b, t, c)

        (times["library_with_layout_ms"],
         times["library_with_layout_eager_ms"]) = time_ms(library_with_layout)
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


COND_BATCH = 32
COND_STEPS = 1000        # the amortized chains (config diffusion.num_steps)
SHORT_STEPS = 50         # guidance and replacement chains, cut from 1000
COND_REUSE = 3           # config testing.encoder_reuse


def flash_o_tol(dtype, want_o):
    """The flash forward's tolerance on o. bf16: 1e-2 of max|o_ref|. Both
    sides round o to bf16 (the plain side after rounding normalised p, the
    kernel after rounding unnormalised p, each 2^-9 relative per term, far
    below one ulp of o), so they differ by at most one bf16 ulp, which is
    at most 2^-7 of max|o_ref|. fp32: 2e-5 absolute, the order of the sums
    only."""
    if dtype == "float32":
        return 2e-5
    return 1e-2 * want_o.float().abs().max().item()


def flash_kernel_phase(torch, F, card_info, path_shapes, dev):
    """The flash forward and backward kernels against their plain versions
    at the path's shapes plus an fp32 and an uneven-T case; returns
    {kernel: per-call sums weighted by the calls per forward}."""
    from tpu_diffusion_torch.kernels import attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    totals = {}
    cases = [(shape, torch.bfloat16, count)
             for shape, count in sorted(path_shapes.items())]
    cases += [((16, 1024, 64), torch.float32, 0),
              ((32, 1000, 64), torch.bfloat16, 0),
              ((8, 1000, 32), torch.float32, 0),
              # bf16, off the path: one tile, d = 32, d = 128 (uneven T)
              ((16, 64, 64), torch.bfloat16, 0),
              ((16, 1000, 32), torch.bfloat16, 0),
              ((8, 520, 128), torch.bfloat16, 0)]
    for (bh, t, d), dtype, count in cases:
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        name = str(dtype).split(".")[-1]
        # forward: o in the inputs' type (tolerance: `flash_o_tol`), lse
        # fp32 on both sides (1e-4 for values ~10: the order of the sums)
        o, lse = attention.flash_attention_fwd(q, k, v)
        want_o, want_lse = attention.flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        tol = flash_o_tol(name, want_o)
        err_o = (o.float() - want_o.float()).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        check(math.isfinite(err_o) and err_o <= tol and err_lse <= 1e-4,
              f"flash forward {bh, t, d} {name}: o err {err_o}, lse err "
              f"{err_lse}")
        # backward from the plain forward's o and lse; tolerance relative
        # to each gradient's largest entry
        delta = (g.float() * want_o.float()).sum(-1)
        bwd_args = (q, k, v, g, want_lse, delta)
        got = attention.flash_attention_bwd(*bwd_args)
        want = attention.flash_attention_bwd_ref(*bwd_args)
        torch.cuda.synchronize()
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        abs_errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, want)]
        errs = [e / b.float().abs().max().item()
                for e, b in zip(abs_errs, want)]
        check(all(math.isfinite(e) and e <= rel for e in errs),
              f"flash backward {bh, t, d} {name}: relative errs {errs}")
        # the bf16 backward sums dq with atomics: two calls on the same
        # inputs may differ in dq's last bits (dk, dv and fp32 may not)
        again = attention.flash_attention_bwd(*bwd_args)
        torch.cuda.synchronize()
        repeat = {"bitwise_equal_dq_dk_dv": [torch.equal(a, b) for a, b
                                             in zip(got, again)],
                  "max_abs_diff_dq_dk_dv": [
                      (a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, again)]}
        check(all(repeat["bitwise_equal_dq_dk_dv"][1:])
              and (dtype == torch.bfloat16
                   or repeat["bitwise_equal_dq_dk_dv"][0])
              and repeat["max_abs_diff_dq_dk_dv"][0]
              <= rel * want[0].float().abs().max().item(),
              f"flash backward {bh, t, d} {name}: two calls differ: {repeat}")

        # SDPA takes its fused backends only for 4-D [B, H, T, d] inputs
        q4, k4, v4, g4 = (x.view(1, bh, t, d) for x in (q, k, v, g))
        fwd_times = measure(
            lambda: attention.flash_attention_fwd(q, k, v),
            lambda: attention.flash_attention_fwd_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(qg, kg, vg)
                return torch.autograd.grad(out, (qg, kg, vg), g4)

        bwd_times = measure(
            lambda: attention.flash_attention_bwd(*bwd_args),
            lambda: attention.flash_attention_bwd_ref(*bwd_args),
            sdpa_fwd_bwd)
        # the library backward: SDPA forward+backward less its forward
        for key in ("library_ms", "library_eager_ms"):
            bwd_times[key] -= fwd_times[key]
        isz = q.element_size()
        n = bh * t * d
        op_rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        # forward: read q, k, v, write o and lse; 4 T^2 d per slice
        fwd_bound = bound_ms(4 * n * isz + bh * t * 4, 4 * bh * t * t * d,
                             op_rate)
        # backward: read q, k, v, g, lse, delta, write dq, dk, dv; the
        # function needs 10 T^2 d per slice (s, dp, dq, dk, dv), which is
        # what the one-pass bf16 kernel executes; the two scalar fp32
        # kernels do 14 (each recomputes s and dp), not counted in the bound
        bwd_bound = bound_ms(7 * n * isz + 2 * bh * t * 4,
                             10 * bh * t * t * d, op_rate)
        for kname, times, (bnd, by), errors, extra in (
                ("flash_attention_fwd", fwd_times, fwd_bound,
                 {"max_abs_err": err_o},
                 {"max_abs_err_lse": err_lse, "tol": tol}),
                ("flash_attention_bwd", bwd_times, bwd_bound,
                 {"max_abs_err": max(abs_errs), "max_rel_err": max(errs)},
                 {"abs_err_dq_dk_dv": abs_errs, "rel_err_dq_dk_dv": errs,
                  "rel_tol": rel, "two_calls": repeat,
                  "ops_executed": (10 if dtype == torch.bfloat16 else 14)
                  * bh * t * t * d})):
            emit(card_info, phase="flash_kernel", kernel=kname,
                 shape=[bh, t, d], dtype=name, count_per_forward=count,
                 **errors, **extra, **times, bound_ms=bnd, bound_by=by)
            if count:
                tot = totals.setdefault(kname, dict(bound_ms=0.0, by={}))
                for key, val in errors.items():
                    tot[key] = max(tot.get(key, 0.0), val)
                tot["bound_ms"] += count * bnd
                tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
                for key, val in times.items():
                    tot[key] = tot.get(key, 0.0) + count * val
    return totals


def twin(cli, config_mod, config, dev, model, **overrides):
    """The model of `config` with `overrides`, carrying `model`'s weights."""
    config = copy.deepcopy(config)
    config_mod.apply_overrides(config, [f"{k}={v}"
                                        for k, v in overrides.items()])
    other = cli.build(config, dev)["model"]
    other.load_state_dict(model.state_dict())
    return other.eval().requires_grad_(False)


def cond_models(torch, cli, unet, config_mod, dev, spec, **overrides):
    """(config, parts, kernel model, plain model) for one spec: the cli's own
    build, random weights from SEED; the plain twin runs
    attention_impl="dense"."""
    config = config_mod.get_config(spec)
    config_mod.apply_overrides(config, [f"{k}={v}"
                                        for k, v in overrides.items()])
    parts = cli.build(config, dev)
    mk = unet.randomize_(parts["model"], torch.Generator().manual_seed(SEED))
    mp = twin(cli, config_mod, config, dev, mk,
              **{"network.attention_impl": "dense"})
    return config, parts, mk.eval().requires_grad_(False), mp


def compare(torch, got, want, what):
    """(fields, ok): eps with the kernels against eps with the plain
    versions, bf16 end to end."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs()
    ok = (bool(torch.isfinite(got).all())
          and diff.max() <= 1e-1 * scale.max()
          and diff.mean() <= 3e-2 * scale.mean())
    return dict(what=what, max_abs_diff=diff.max().item(),
                mean_abs_diff=diff.mean().item(),
                max_abs_ref=scale.max().item(),
                mean_abs_ref=scale.mean().item(),
                tol="max <= 0.1 * max|ref|, mean <= 0.03 * mean|ref|: bf16 "
                    "end to end; a wrong head split or softmax moves the "
                    "output by O(1)"), ok


def flash_blocks(model):
    """(flash blocks in the encoder, in middle + decoder), from the decision
    log of the model's last full forward."""
    enc = sum(1 for n, d in model.attn_decisions.items()
              if d["impl"] == "flash" and n.startswith("enc_"))
    dec = sum(1 for n, d in model.attn_decisions.items()
              if d["impl"] == "flash" and not n.startswith("enc_"))
    return enc, dec


def conditional_phase(torch, F, card_info, dev):
    """The 64px conditional path of `cli.main --mode eval`; returns
    (kernel totals, {kernel: launches on the path})."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.data.registry import get_dataset
    from tpu_diffusion_torch.eval.metrics import eval_statistics
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.models import unet
    from tpu_diffusion_torch.sampling import ancestral
    from tpu_diffusion_torch.utils import config as config_mod
    spec_a = "flowers,inpainting,amortized"
    spec_g = "flowers,inpainting,reconstruction_guidance"
    cfg_a, parts_a, amort, amort_plain = cond_models(
        torch, cli, unet, config_mod, dev, spec_a,
        **{"testing.lpips": "false"})
    cfg_g, parts_g, uncond, uncond_plain = cond_models(
        torch, cli, unet, config_mod, dev, spec_g,
        **{"testing.lpips": "false", "diffusion.num_steps": SHORT_STEPS})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    imgs = torch.from_numpy(
        get_dataset("flowers")("data", train=False).images[:COND_BATCH]
    ).to(dev)
    t = torch.full((COND_BATCH,), 0.5, device=dev)

    # --- full-width forward: kernels against plain versions -------------
    path_shapes = {}
    for name, (mk, mp, lik) in {
            "amortized": (amort, amort_plain, parts_a["likelihood"]),
            "unconditional": (uncond, uncond_plain, None)}.items():
        x = torch.randn(imgs.shape, generator=gen, device=dev)
        if lik is not None:
            x = torch.cat([x, lik.sample(gen, imgs)], dim=-1)
        mk.attn_decisions.clear()
        with torch.no_grad():
            got, want = mk(x, t), mp(x, t)
        torch.cuda.synchronize()
        fields, ok = compare(torch, got, want, "eps")
        decisions = {n: d["impl"] for n, d in mk.attn_decisions.items()}
        flash = sorted(n for n, i in decisions.items() if i == "flash")

        def forward(model=mk, x=x):
            with torch.no_grad():
                return model(x, t)

        device_ms, eager_ms = time_ms(forward, iters=3)
        emit(card_info, phase="cond_forward", model=name,
             shape=list(x.shape), **fields, attn_decisions=decisions,
             device_ms=device_ms, eager_ms=eager_ms,
             device_idle_share=1 - device_ms / eager_ms)
        check(ok, f"cond_forward {name}: kernels disagree with plain "
                  f"versions")
        check(flash == ["dec_attn_1_0", "dec_attn_1_1", "dec_attn_1_2",
                        "enc_attn_1_0", "enc_attn_1_1"]
              and all(mk.attn_decisions[n]["tokens"] == 1024 for n in flash)
              and set(decisions.values()) == {"flash", "dense"},
              f"cond_forward {name}: attention decisions {decisions}")
        if name == "amortized":  # both models make the same flash calls
            for n in flash:
                d = mk.attn_decisions[n]
                c = getattr(mk, n).qkv.in_features
                key = (COND_BATCH * d["heads"], d["tokens"], c // d["heads"])
                path_shapes[key] = path_shapes.get(key, 0) + 1
    check(path_shapes == FLASH_PATH_SHAPES,
          f"the 64px UNet's flash calls {path_shapes}")
    totals = flash_kernel_phase(torch, F, card_info, path_shapes, dev)

    # --- guidance gradient: kernels against plain versions ---------------
    lik_g = parts_g["likelihood"]
    ddpm_g = parts_g["ddpm"].to(dev)
    cond_g = lik_g.sample(gen, imgs)
    ib = torch.full((COND_BATCH,), 10, dtype=torch.long, device=dev)
    xi, _ = ddpm_g.q_sample(imgs, ib, generator=gen)
    # bf16 (the path's type): a pixel whose x0 prediction crosses the
    # [-1, 1] clip on one side only has its whole gradient on one side, so
    # the relative error is loose; fp32: the kernels' fp32 path, where the
    # two sides differ by the order of their sums and the clip hardly ever
    # decides differently
    pairs = {"bfloat16": (uncond, uncond_plain, 0.1)}
    pairs["float32"] = tuple(
        twin(cli, config_mod, cfg_g, dev, uncond, **{
            "network.dtype": "float32", "network.attention_impl": impl})
        for impl in ("auto", "dense")) + (1e-3,)
    for dtype, (mk, mp, tol) in pairs.items():
        grads = {}
        f0, b0 = attention.flash_fwd_launches, attention.flash_bwd_launches
        for side, model in (("kernel", mk), ("plain", mp)):
            x0_model = ancestral.make_x0_model(
                lambda x, i, m=model: m(x, i.float() / SHORT_STEPS), ddpm_g)
            grads[side] = ancestral.guidance_gradient(x0_model, lik_g,
                                                      cond_g, xi, ib)
        torch.cuda.synchronize()
        gk, gp = grads["kernel"], grads["plain"]
        rel = ((gk - gp).norm() / gp.norm()).item()
        launched = (attention.flash_fwd_launches - f0,
                    attention.flash_bwd_launches - b0)
        emit(card_info, phase="guidance_grad", dtype=dtype,
             shape=list(xi.shape), step=10, rel_l2_err=rel, tol=tol,
             max_abs_diff=(gk - gp).abs().max().item(),
             max_abs_grad=gp.abs().max().item(),
             flash_fwd_launches=launched[0], flash_bwd_launches=launched[1],
             note="|g_kernel - g_plain|_2 / |g_plain|_2 of d/dx_i sum "
                  "loss(x0(x_i)) through the UNet forward and backward")
        check(bool(torch.isfinite(gk).all()) and gp.abs().max() > 0
              and rel <= tol,
              f"guidance gradient {dtype}: relative error {rel}")
        check(launched == (5, 5), f"guidance gradient {dtype}: flash "
                                  f"launches {launched}")

    # --- sampling: the main path ------------------------------------------
    enc, dec = flash_blocks(amort)
    cond_sample_a, _ = cli.make_samplers(cfg_a, parts_a)
    cfg_k1 = config_mod.get_config(spec_a)
    config_mod.apply_overrides(cfg_k1, ["testing.encoder_reuse=1"])
    plain_sample_a, _ = cli.make_samplers(cfg_k1, parts_a)
    ddpm_a = parts_a["ddpm"]

    def k1_cached(model, xT, condition, generator):
        def call(x, i, **kw):
            return model(x, i.float() / COND_STEPS, **kw)
        return ancestral.make_cached_amortized_sampler(
            lambda x, i: call(x, i, mode="encode"),
            lambda x, i, c: call(x, i, mode="decode", cache=c),
            ddpm_a, parts_a["conditioning"], parts_a["likelihood"],
            encoder_reuse=1)(xT, condition, generator)

    cfg_o = config_mod.get_config("flowers,outpainting,replacement")
    config_mod.apply_overrides(cfg_o, [f"diffusion.num_steps={SHORT_STEPS}",
                                       "testing.lpips=false"])
    parts_o = cli.build(cfg_o, dev)
    replace_sample, _ = cli.make_samplers(cfg_o, parts_o)
    guided_sample, _ = cli.make_samplers(cfg_g, parts_g)
    n_a = len(ancestral.reuse_groups(range(COND_STEPS), COND_REUSE))
    runs = [
        # (name, sampler, model, likelihood, steps, fwd, bwd launches)
        ("amortized_k3", cond_sample_a, amort, parts_a["likelihood"],
         COND_STEPS, n_a * enc + COND_STEPS * dec, 0),
        ("amortized_k1_cached", k1_cached, amort, parts_a["likelihood"],
         COND_STEPS, COND_STEPS * (enc + dec), 0),
        ("amortized_plain", plain_sample_a, amort, parts_a["likelihood"],
         COND_STEPS, COND_STEPS * (enc + dec), 0),
        ("guidance", guided_sample, uncond, lik_g, SHORT_STEPS,
         SHORT_STEPS * 2 * (enc + dec), SHORT_STEPS * (enc + dec)),
        ("outpainting_replacement", replace_sample, uncond,
         parts_o["likelihood"], SHORT_STEPS, SHORT_STEPS * (enc + dec), 0),
    ]
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    outs = {}
    for name, sampler, model, lik, steps, want_f, want_b in runs:
        run_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        condition = lik.sample(run_gen, imgs)
        xT = torch.randn(imgs.shape, generator=run_gen, device=dev)
        torch.cuda.synchronize()
        attention.flash_fwd_launches = 0
        attention.flash_bwd_launches = 0
        s0 = time.perf_counter()
        out = sampler(model, xT, condition, run_gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        got_f = attention.flash_fwd_launches
        got_b = attention.flash_bwd_launches
        launches["flash_attention_fwd"] += got_f
        launches["flash_attention_bwd"] += got_b
        outs[name] = out
        stats = {k: v.item() for k, v in eval_statistics(out, imgs).items()}
        emit(card_info, phase="sample", run=name, batch=COND_BATCH,
             steps=steps, seconds=seconds,
             samples_per_s=COND_BATCH / seconds,
             ms_per_step=seconds * 1e3 / steps,
             flash_fwd_launches=got_f, flash_fwd_expected=want_f,
             flash_bwd_launches=got_b, flash_bwd_expected=want_b,
             out_min=out.min().item(), out_max=out.max().item(), **stats,
             note="random weights: the metrics make no quality claim"
             + ("" if steps == COND_STEPS else
                f"; chain cut from 1000 to {steps} steps to keep the run "
                f"short"))
        check(bool(torch.isfinite(out).all()) and out.abs().max() <= 1.0
              and out.shape == imgs.shape, f"sample {name}: bad output")
        check((got_f, got_b) == (want_f, want_b),
              f"sample {name}: flash launches {(got_f, got_b)}, want "
              f"{(want_f, want_b)}")
    same = torch.equal(outs["amortized_k1_cached"], outs["amortized_plain"])
    diff = (outs["amortized_k1_cached"] - outs["amortized_plain"]
            ).abs().max().item()
    emit(card_info, phase="sample", run="k1_equals_plain", equal=same,
         max_abs_diff=diff)
    check(same, f"cached K=1 differs from the plain amortized sampler by "
                f"{diff}")

    cfg_h = config_mod.get_config("flowers,hyperresolution,replacement")
    parts_h = cli.build(cfg_h, dev)
    hyper_sample, _ = cli.make_samplers(cfg_h, parts_h)
    try:
        hyper_sample(uncond, imgs, imgs)
        rejected = ""
    except NotImplementedError as err:
        rejected = str(err)
    emit(card_info, phase="sample", run="hyperresolution_replacement",
         rejected=rejected)
    check("requires a Painting likelihood" in rejected,
          "hyperresolution replacement was not rejected")
    return totals, launches


ENGINE_BLOCKS = ["dec_0_0", "dec_0_1", "dec_0_2", "enc_0_0", "enc_0_1"]


def engine_phase(torch, card_info, models, samplers, x, t, xT):
    """The fused-inference engine on the CIFAR UNet: its forward against the
    plain model's for both norm configurations, then DDIM-100 (K=3 and K=1)
    through the engine over the fused-norm model. Returns the ResBlock
    kernel's launches in the two DDIM runs."""
    from tpu_diffusion_torch.kernels import resblock
    from tpu_diffusion_torch.models.unet_infer import make_fused_apply
    engines = {}
    for name, (mk, mp) in models.items():
        fn = engines[name] = make_fused_apply(mk)
        before = resblock.launches
        with torch.no_grad():
            got, want = fn(x, t), mp(x, t)
        torch.cuda.synchronize()
        fields, ok = compare(torch, got, want, "eps")
        on_kernel = sorted(n for n, d in fn.res_decisions.items()
                           if d["impl"] == "kernel")
        device_ms, eager_ms = time_ms(lambda fn=fn: fn(x, t), iters=5)

        def forward(model=mk):
            with torch.no_grad():
                return model(x, t)

        model_ms, model_eager = time_ms(forward, iters=5)
        emit(card_info, phase="engine_forward", config=name, batch=BATCH,
             shape=list(got.shape), **fields, res_decisions={
                 n: d["impl"] for n, d in fn.res_decisions.items()},
             kernel_launches=resblock.launches - before,
             layout_copies=fn.layout_copies, device_ms=device_ms,
             eager_ms=eager_ms, model_device_ms=model_ms,
             model_eager_ms=model_eager,
             note="model_*: the same UNet without the engine (cuDNN "
                  "ResBlocks), timed in turn")
        check(ok, f"engine_forward {name}: the engine disagrees with the "
                  f"plain model")
        check(on_kernel == ENGINE_BLOCKS
              and all(fn.res_decisions[n]["tokens"] == 1024
                      for n in on_kernel)
              and len(fn.res_decisions) == 22,
              f"engine_forward {name}: decisions {fn.res_decisions}")
        check(fn.layout_copies == 0,
              f"engine_forward {name}: {fn.layout_copies} layout copies")

    fn = engines["norm_fused"]
    for k in (REUSE, 1):  # warm-up, not counted
        samplers(fn, 2 * REUSE)[k](xT)
    torch.cuda.synchronize()
    resblock.launches = 0
    n_enc = math.ceil(STEPS / REUSE)
    for k, want_n in ((REUSE, 2 * n_enc + 3 * STEPS), (1, 5 * STEPS)):
        before = resblock.launches
        sample = samplers(fn, STEPS)[k]
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = sample(xT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        got_n = resblock.launches - before
        emit(card_info, phase="engine_ddim", config="norm_fused",
             encoder_reuse=k, batch=BATCH, steps=STEPS, seconds=seconds,
             samples_per_s=BATCH / seconds, ms_per_step=seconds * 1e3 / STEPS,
             resblock_launches=got_n, resblock_expected=want_n,
             out_min=out.min().item(), out_max=out.max().item(),
             out_std=out.float().std().item())
        check(bool(torch.isfinite(out).all()) and out.abs().max() <= 1.0
              and out.shape == xT.shape, f"engine_ddim K={k}: bad output")
        check(got_n == want_n, f"engine_ddim K={k}: {got_n} ResBlock kernel "
                               f"launches, want {want_n}")
    return resblock.launches


TRAIN_STEPS = 20


def train_phase(torch, card_info, dev):
    """DDPM training of `cli.main --mode train` at 64px width through the
    cli's own functions, a checkpoint round trip, and `--mode eval` from
    it. Returns the flash kernels' launches in the training steps."""
    import shutil
    import tempfile

    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.data.registry import (get_dataset,
                                                   infinite_batches)
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.train.checkpoint import CheckpointManager
    from tpu_diffusion_torch.train.trainer import Trainer, make_train_step
    from tpu_diffusion_torch.utils import config as config_mod
    spec = "flowers,inpainting,amortized"
    overrides = ["testing.lpips=false", f"training.num_steps={TRAIN_STEPS}",
                 f"training.seed={SEED}"]
    config = config_mod.get_config(spec)
    config_mod.apply_overrides(config, overrides)
    torch.manual_seed(SEED)  # the model's own initialisation
    parts = cli.build(config, dev)
    state, _ = cli.init_state(config, parts)
    step_fn = make_train_step(
        cli.make_loss(parts), ema_decay=config.training.ema_decay,
        ema_update_every=config.training.ema_update_every)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    ema_before = {k: v.clone() for k, v in state.ema.params.items()}
    train_ds = get_dataset("flowers")("data", train=True)
    batches = infinite_batches(train_ds, config.training.batch_size,
                               seed=SEED)
    trace = []

    def hook(step, m):  # reading the metrics synchronises the device
        trace.append((time.perf_counter(), m["loss"], m["grad_norm"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.flash_fwd_launches = 0
    attention.flash_bwd_launches = 0
    t0 = time.perf_counter()
    state = Trainer(step_fn, state, batches).fit(TRAIN_STEPS,
                                                 metrics_hook=hook)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": attention.flash_fwd_launches,
                "flash_attention_bwd": attention.flash_bwd_launches}
    stamps = [t0] + [s for s, _, _ in trace]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    later = sorted(step_ms[1:])
    losses = [l for _, l, _ in trace]
    gnorms = [g for _, _, g in trace]
    still = [k for k, v in state.params.items() if torch.equal(v, before[k])]
    moved = len(before) - len(still)
    ema_moved = sum(1 for k, v in state.ema.params.items()
                    if not torch.equal(v, ema_before[k]))
    dtypes = sorted({str(v.dtype) for v in state.params.values()})

    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ckpt = CheckpointManager(f"{workdir}/ckpt")
        assets = {"params": state.params, "ema": state.ema.params,
                  "step": state.step}
        ckpt.save(state.step, assets)
        loaded, restored = ckpt.load(assets)
        same = restored == state.step and all(
            torch.equal(loaded[tree][k], v.cpu())
            for tree in ("params", "ema") for k, v in assets[tree].items())
        emit(card_info, phase="train", config=spec, batch=config.training
             .batch_size, steps=TRAIN_STEPS, first_step_ms=step_ms[0],
             ms_per_step_median=later[len(later) // 2],
             ms_per_step_min=later[0], ms_per_step_max=later[-1],
             loss_first=losses[0], loss_last=losses[-1],
             grad_norm_first=gnorms[0], grad_norm_last=gnorms[-1],
             param_dtypes=dtypes, compute_dtype=str(state.model.dtype),
             params_moved=moved, ema_params_moved=ema_moved,
             params_not_moved=still[:20],
             n_param_tensors=len(before),
             n_params=sum(v.numel() for v in before.values()),
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             flash_fwd_launches=launches["flash_attention_fwd"],
             flash_bwd_launches=launches["flash_attention_bwd"],
             checkpoint_equal=same,
             note="ms per step: host clock between the per-step metric "
                  "reads (each a device synchronisation), after the first "
                  "step; synthetic images; the model's own initialisation "
                  "from the seed")
        check(all(math.isfinite(v) for v in losses + gnorms),
              f"train: loss {losses} grad_norm {gnorms}")
        check(dtypes == ["torch.float32"]
              and state.model.dtype == torch.bfloat16,
              f"train: parameter types {dtypes}")
        # the output convs start at zero and the schedule warms up over 1000
        # steps, so the gradients that reach the deepest blocks in 20 steps
        # are still below Adam's eps and an fp32 ulp of their parameters
        check(2 * moved >= len(before) and 2 * ema_moved >= len(before)
              and "conv_out.weight" not in still,
              f"train: {moved} parameters and {ema_moved} EMA parameters of "
              f"{len(before)} moved")
        check(launches == {"flash_attention_fwd": 5 * TRAIN_STEPS,
                           "flash_attention_bwd": 5 * TRAIN_STEPS},
              f"train: flash launches {launches}")
        check(same, "train: the checkpoint read back differs")
        del loaded, before, ema_before
        ema = {k: v.clone() for k, v in state.ema.params.items()}
        del state, assets
        torch.cuda.empty_cache()

        # --mode eval from that workdir: the EMA parameters, a 50-step chain
        seen = {}
        real_run_eval = cli.run_eval

        def spy(cfg, prts, model, *a, **kw):
            seen.update({k: v.detach().clone()
                         for k, v in model.named_parameters()})
            return real_run_eval(cfg, prts, model, *a, **kw)

        cli.run_eval = spy
        try:
            args = ["--config", spec, "--mode", "eval", "--workdir", workdir,
                    "--device", dev.type]
            for o in overrides + [f"diffusion.num_steps={SHORT_STEPS}",
                                  f"testing.num_test={COND_BATCH}",
                                  f"testing.batch_size={COND_BATCH}"]:
                args += ["--override", o]
            s0 = time.perf_counter()
            results = cli.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - s0
        finally:
            cli.run_eval = real_run_eval
        restored_ema = sorted(seen) == sorted(ema) and all(
            torch.equal(seen[k], v) for k, v in ema.items())
        emit(card_info, phase="train", run="eval_from_checkpoint",
             steps=SHORT_STEPS, seconds=seconds, results=results,
             ema_restored=restored_ema,
             note=f"chain cut from 1000 to {SHORT_STEPS} steps; 20 training "
                  f"steps: the metrics make no quality claim")
        check(restored_ema, "train: --mode eval did not restore the EMA "
                            "parameters of the checkpoint")
        check(results["num_images"] == COND_BATCH
              and all(math.isfinite(v) for v in results.values()),
              f"train: eval results {results}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


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
    if sys.argv[1:] == ["--kernels"]:
        kernel_phase(torch, F, card_info, ATTN_PATH_SHAPES, {})
        flash_kernel_phase(torch, F, card_info, FLASH_PATH_SHAPES, dev)
        print(json.dumps({"partial": "--kernels: the attention kernels' "
                                     "cases only"}), flush=True)
        return 0
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen).to(dev)
    t = torch.full((BATCH,), 0.5, device=dev)

    models = {name: build_models(torch, unet, dev, **resolve(torch, cfg))
              for name, cfg in NORM_CONFIGS.items()}
    attn_shapes, norm_shapes, res_shapes = capture_shapes(
        torch, models["norm_fused"][0], x, t, nn_mod, unet)
    check(attn_shapes == ATTN_PATH_SHAPES,
          f"the CIFAR UNet's attention calls {attn_shapes}")
    totals = kernel_phase(torch, F, card_info, attn_shapes, norm_shapes)
    totals.update(resblock_phase(torch, card_info, res_shapes, unet, dev))

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

    # --- the fused-inference engine on the same UNet ----------------------
    counts["fused_resblock"] = engine_phase(torch, card_info, models,
                                            samplers, x, t, xT)
    del models
    torch.cuda.empty_cache()

    # --- the conditional path of cli.main at 64px -------------------------
    cond_totals, cond_counts = conditional_phase(torch, F, card_info, dev)
    totals.update(cond_totals)
    counts.update(cond_counts)

    # --- DDPM training of cli.main at 64px ---------------------------------
    for name, n in train_phase(torch, card_info, dev).items():
        counts[name] += n
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")

    meta = {
        "flash_attention_fused": (
            "tpu_diffusion_torch/kernels/csrc/attention_fused.cu",
            "tpu_diffusion/kernels/attention.py:362"),
        "fused_groupnorm_silu": (
            "tpu_diffusion_torch/kernels/csrc/groupnorm_silu.cu",
            "tpu_diffusion/kernels/groupnorm.py:82"),
        "flash_attention_fwd": (
            "tpu_diffusion_torch/kernels/csrc/flash_attention.cu",
            "tpu_diffusion/kernels/attention.py:77"),
        "flash_attention_bwd": (
            "tpu_diffusion_torch/kernels/csrc/flash_attention.cu",
            "tpu_diffusion/kernels/attention.py:171"),
        "fused_resblock": (
            "tpu_diffusion_torch/kernels/csrc/resblock.cu",
            "tpu_diffusion/kernels/resblock.py:242"),
    }
    per = {
        "flash_attention_fused": "one full CIFAR UNet forward at batch 64 "
                                 "(sum over its call shapes); launches: the "
                                 "four DDIM-100 runs",
        "fused_groupnorm_silu": "one full CIFAR UNet forward at batch 64 "
                                "(sum over its call shapes); launches: the "
                                "four DDIM-100 runs",
        "flash_attention_fwd": "one full 64px UNet forward at batch 32 (5 "
                               "calls); launches: the five conditional "
                               "sampling runs and the 20 training steps",
        "flash_attention_bwd": "one guidance gradient through the 64px UNet "
                               "at batch 32 (5 calls); launches: the "
                               "guidance run and the 20 training steps; "
                               "max_rel_err: the largest |dq, dk, dv - "
                               "plain| over each gradient's largest entry",
        "fused_resblock": "one full CIFAR UNet forward through the engine "
                          "at batch 64 (its 5 calls); launches: the two "
                          "engine DDIM-100 runs; library_ms: the port's "
                          "ResBlock module, cuDNN convs with the eager norm "
                          "chain (library_gn_kernel_ms: with the GN kernel)",
    }
    table = []
    for name, (source, replaces) in meta.items():
        tot = totals[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": tot["max_abs_err"],
            **{k: tot[k] for k in ("max_rel_err", "library_gn_kernel_ms",
                                   "library_with_layout_ms") if k in tot},
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": max(tot["by"], key=tot["by"].get),
            "library_ms": tot["library_ms"],
            "eager_ms": tot["eager_ms"],
            "plain_eager_ms": tot["plain_eager_ms"],
            "library_eager_ms": tot["library_eager_ms"],
            "per": per[name] + "; ms: device time (CUDA-graph replay), "
                               "eager_ms: launched from Python"})
    print(json.dumps({"kernels": table}), flush=True)
    print(card_info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
