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
           d=32 and d=128, and for the GN kernel an image too large for its
           one-launch cluster route (the two-pass route); each GN line names
           its route and whether two calls agree bitwise; time of the
           kernel, the plain version and one PyTorch library call (device
           time from CUDA-graph replay, and eager time from Python; for
           attention also SDPA with the layout copies a library route would
           pay), beside the kernel's bound;
  gn_backward  the GroupNorm backward kernel at the 61 calls of one 64px
           training step (batch 32, bf16; `--gn-backward` runs it alone):
           its gradients against autograd through the plain version, two
           calls bitwise, its route and the other route's time, its time
           beside its bound, and forward + backward through the kernel
           pair, the plain chain and F.group_norm;
  adam     the fused clip + Adam + EMA kernel at the 64px UNet's 368
           parameter tensors (`--adam` runs it alone): one update against
           the plain version on copies, bitwise; its time on a step
           that keeps the EMA and on one that blends it, beside the bytes
           bound; the optimizer's whole update (global norm included) on
           the "fused" and "foreach" routes; the foreach chain it replaces
           and torch.optim.Adam(fused=True) (Adam alone) as yardsticks;
  forward  the full-width bench UNet (CIFAR-10, 128 channels, batch 64,
           bf16, random weights from seed 0): eps with the kernels against
           eps with the plain versions, for both norm configurations;
  forward_time  one forward's device time (CUDA graph) and eager time;
  ddim     DDIM-100 with encoder reuse K=3 and plain K=1, both norm
           configurations, each timed once, eager: samples/s, outputs
           finite and in [-1, 1], the kernels' launch counts equal to what
           the path implies, and every attention block on the fused kernel.
The fused-inference engine (`models/unet_infer.py`) on the same UNet:
  resblock_kernel  the whole-ResBlock kernel against its plain version at
           the five shapes the engine gives it (batch 64, bf16), plus an
           fp32, an additive-mode and an identity-skip case, and the 64px
           UNet's first ResBlock ([32,64,64,128] -> 128; in no path's
           sums); each
           line names its route ("wgmma" at every path shape,
           `kernels/resblock.py:resblock_route`) and whether two calls agree
           bitwise; times as in `kernel`, with the port's own `ResBlock`
           module (cuDNN convs; the eager norm chain, and the GN kernel) as
           the library yardstick;
  engine_forward  eps through the engine (its five 32x32 ResBlocks on the
           kernel) against eps of the plain model, both norm
           configurations, with the engine's decision log; one forward's
           device and eager time beside the model's own;
  engine_ddim  DDIM-100 through the engine, K=3 and K=1: samples/s, outputs
           finite and in [-1, 1], and the ResBlock kernel's launch count
           equal to what the path implies (368 and 500).
The graphed chains (`sampling/graph.py`: a sampler's step, or K-step group,
captured once as a CUDA graph and replayed), each against its eager loop:
  graphs   DDIM-100 K=3 and K=1 at batch 64 through the engine and through
           the model with the GN kernel; the cached amortized 64px chain of
           `cli.main` (K=3, cut to GRAPH_COND_STEPS); Euler-Maruyama over
           an exact Gaussian score; the SR256 eval's Euler-20 (the flash
           forward at [32,1024,64]); the MPNN's design at its published
           width; the unguided protein chain (cut to GRAPH_PROTEIN_STEPS);
           the reconstruction-guidance 64px chain of `cli.make_samplers`
           (gamma 10, batch 32) at start_fraction 0.5 and 1.0 in bf16 (50
           steps) and at 0.5 in fp32 (22 steps; GUIDED_RUNS: its guided
           body differentiates inside the capture, the flash backward
           replayed; fp32 bitwise with cuDNN's deterministic algorithms,
           the one check that vouches for the guided body; bf16's mean
           |difference| within twice that of two eager chains):
           the outputs bitwise equal (or within the full forward's
           tolerance, ROADMAP trap (d)), the replays' kernel launches equal
           to the eager chain's, capture seconds and pool bytes per body,
           wall and device ms per chain (median and quartiles over
           GRAPH_REPEATS chains; device: the sum of the replays' CUDA-event
           times), the idle share; then a capture with a host read in its
           body, which must raise (in a process of its own). Launch checks
           on graphed chains elsewhere count what ran: the wrappers' calls
           less the warm-ups' and captures', plus the replays'
           (`kernels.executed_launches`).
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
           kernels against their plain versions at the paths' shapes
           [128, 1024, 64] (this UNet) and [32, 1024, 64] (the SR256
           wrapper below, batch 8, its calls captured from one forward of
           it) bf16, fp32 cases, and in bf16 an uneven T, one
           tile (T=64), d=32, d=128, and the forward's TMA / `wgmma` route at
           T=128 and T=2048; the forward's route; whether two calls on the
           same inputs agree bitwise (the forward always; the backward sums
           dq with atomics); times as in `kernel`, SDPA forward and its
           autograd backward as the library yardstick;
  guidance_grad  the reconstruction-guidance gradient w.r.t. x_i through
           the whole UNet with the kernels against the plain versions;
  sample   amortized inpainting over 250 steps (cut from 1000) with
           encoder reuse K=3 and K=1 (K=1 equal to the plain amortized
           sampler), reconstruction guidance (gamma 10, every step guided)
           and outpainting replacement on a 50-step chain (cut from 1000 to
           keep the run short), and the rejected hyperresolution
           replacement (cli.make_samplers' chains graphed); samples/s,
           MSE/PSNR/SSIM against the (synthetic) test images (random
           weights: no quality claim), outputs finite and in [-1, 1], and
           the flash kernels' launch counts equal to what the path implies.
DDPM training of `tpu_diffusion_torch.cli.main --mode train` on the same
64px configuration (flowers,inpainting,amortized; fp32 parameters, bf16
forward, batch 32, synthetic images):
  train    20 steps through the cli's own functions (`build`, `init_state`,
           `make_loss`, the trainer; graphed: two eager warm-up steps, a
           capture, one replay a step): ms per step after the first, loss
           and gradient norm finite at every step, parameters and EMA
           parameters moved, 5 flash forward and 5 flash backward launches
           and 61 GroupNorm forward and 61 backward launches (cli.build's
           norm_impl="fused" on the card) per step that ran (replays
           included), each replay's device
           time, a checkpoint written and read back equal, then `cli.main
           --mode eval` from that checkpoint on a 50-step chain.
  eval_metrics  `cli.main --mode eval` on the same 64px model (random
           weights from seed 0, one batch of 32, a 50-step chain) with
           testing.lpips, testing.fid and random_conv features: LPIPS, FID
           and the caveat fields of results.json, the flash forward's
           launches equal to what the chain implies, LPIPS(x, x) = 0 and
           FID(real, real) <= 1e-3, each feature network's device time per
           batch beside the sampler's, and the RandomConv, VGG and
           Inception features on the card against the CPU (fp32, relative
           1e-4).
CIFAR-10 conditional flow matching (`cli/train_cifar10.py`,
`cli/compute_fid.py`; synthetic CIFAR-10):
  cfm_train  20 OT-CFM steps (exact host OT pairs) at the config's full
           width and batch 128 through `train_cifar10.main`: median ms per
           step over steps 2-20, peak memory, losses finite, fp32
           parameters, checkpoints at steps 10 and 20, the 64-image
           Euler-100 grid finite in [-1, 1]; then 5 I-CFM steps (the
           unpaired path);
  cfm_fid  `compute_fid.main` on that checkpoint, random_conv features,
           one batch of 512 images each by Euler-100, by dopri5 (the early
           exit, graphed) and by the calibrated fixed-trip dopri5 in
           segments of 8 trips (`--dopri5_fixed_trip true
           --dopri5_chunk 8`, `Dopri5Chunked`): FID, NFE,
           dopri5_truncated, the trip budget and the seconds taken;
  graphs (dopri5_cifar)  dopri5's early exit on compute_fid's field (the
           checkpoint's live parameters), batch DOPRI5_BATCH (cut from
           1024), tol 1e-5, graphed against the eager loop: x bitwise
           and the NFE equal, wall and device ms, idle shares; then the
           fixed-trip scan (graphed) and
           `Dopri5Chunked` at the calibrated budget, x bitwise and the NFE
           equal to the early exit's.
The CFM conditional CLIs (`cli/train_cfm_conditional.py`,
`cli/train_conditional_mnist.py`; synthetic data) and the SDE samplers:
  cfm_cond_sr256  4x super-resolution on synthetic256 at full width (128
           channels, (1,1,2,2,4,4), attention at 32/16/8 with 4 heads; the
           five 32x32 blocks run the flash kernels at T=1024, d=64), bf16
           forward, fp32 parameters, batch 8, 20 steps (warmup cut to 5),
           then one eval batch of 8 by Euler-20: median ms per step over
           steps 2-20, peak memory, the parameter count held to the JAX
           model's (SR256_PARAMS), losses and eval metrics finite, 5 flash
           forward and 5 backward launches per step and 5 forward per eval
           NFE, the checkpoint read back equal;
  parallel (a) the same CLI at that width, batch 8, 10 steps, with
           --sequence_parallel --model_axis 1 in a one-rank NCCL world
           (`parallel/distributed.py:initialize_distributed` from
           COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) and with no
           process group, in turns (mesh, plain, plain, mesh): ms per step
           of each, the losses (the first step's bitwise equal, all within
           1e-3: the bf16 flash backward's atomic dq sums vary from call to
           call, plain against plain too), every sp decision "no mesh
           axis", 5 flash forward and 5 backward launches per step; (b)
           the ring (`parallel/sp.py:simulated_ring_attention`, 4 token
           shards rotated on one card) at [32, 1024, 64] bf16 against the
           flash kernels and the fp32 plain version, o and the gradients,
           and its time as a simulated one-card figure;
  cfm_cond_64  weighted inpainting on flowers at its defaults (64px, 128
           channels, attention at 16x16: dense, no kernel), batch 32, 10
           steps, one eval batch of 8 by dopri5 (its graphed early exit:
           the replays counted against the NFE): ms per step, NFE, whether
           dopri5 finished;
  cond_mnist  `train_conditional_mnist.main` for cfm, otcfm and sf2m at 32
           channels and batch 128, 20 steps each, then the 10x8 class grid
           (Euler-100, the SDE for sf2m): ms per step, the class
           consistency fields, the grid finite in [-1, 1];
  sde      Euler-Maruyama, the probability flow and predictor-corrector on
           the card over the exact score of a Gaussian
           (`core/analytic.py`): the recovered mean and spread within the
           JAX test's tolerances.
The protein stack (`cli/train_protein.py`, `cli/sample_protein.py`) at the
reference width: 112 residues, (256, 64), 5 GVP conv layers, 250 diffusion
steps, fp32 with TF32 off (no kernel on this path: dense products and
elementwise work):
  protein_forward  the parameter count held to the JAX model's
           (PROTEIN_PARAMS), one forward at batch 20 on the card against the
           CPU (same weights), its device time beside its fp32 bound (the
           Linear layers' FLOPs counted from their shapes, at 67 TFLOP/s);
  protein_train  `train_protein.main` at batch 32 for 10 steps, then again
           to 15 (resumed from its checkpoint), graphed: ms per step
           (median and quartiles, the replays' device time and wall), peak
           memory, and an eager step's device time by kernel class
           (`fit_scanned`: phase train_graphs);
  protein_sample  `sample_protein.main` from that checkpoint, 20 chains of
           250 steps, guided (gs 1500 for steps < 125) and unguided:
           seconds per chain, ms per guided and unguided step, peak memory,
           cond_loss_mean, every sample finite (the unguided ones COM-free),
           and one guided and one plain step under the profiler (what the
           SVD's synchronisations cost: `tpu_diffusion_torch/protein/
           sync_probe.py`).
The evaluation of the 20 guided samples (no kernel; host numpy and C++,
and the CA-ProteinMPNN in fp32 on the card):
  protein_eval_mpnn  the MPNN at its published width (hidden 128, k 48,
           3+3 layers, random weights from seed 0), its parameter count
           held to the JAX model's (MPNN_PARAMS); on the first sample the
           card against the CPU: teacher-forced log-probs (1e-4), k-NN
           sets, the designed sequence with the same order and Gumbel
           draws (the first differing step and its margin if not), host
           syncs per design; one pass's and one decode step's device time
           beside their fp32 bound (GEMM FLOPs by FlopCounterMode), a
           step's launches and wall time, the seconds per designed
           sequence and the card's idle share across one;
  protein_eval_self_consistency  `self_consistency_eval` at n_seq 3 (20
           rows, scores in (0, 1], each sequence as long as its sample,
           protein_mpnn_seqs.csv), then a design with the sampling motif's
           indices fixed to MOTIF_RES, which they keep;
  protein_eval_cli  `protein.evaluate.main --novelty --compare_train
           --max_train 200`: summary_stats.json's keys, 20 rows in
           sample_stats.csv, novelty TM and GDT in [0, 1], finite
           Wasserstein fields; the C++ scan against numpy (1e-9); the
           seconds of main, the novelty scan and `eval_many` at n_jobs 1
           and -1, and a spawned worker's start.
The training step as a captured CUDA graph (`train/graph.py`), against the
eager loop, through the training CLIs' own build functions at their
widths:
  train_graphs  per configuration, eager and graphed runs from one seed in
           turns: `cli.main` flowers,inpainting,amortized (batch 32, bf16,
           the flash kernels at [128,1024,64]; also with `use_checkpoint`
           at dropout TG_DROPOUT), the SR256 CFM CLI (batch
           8, [32,1024,64]), `train_cifar10` OT-CFM with exact host pairs
           (batch 128), `train_conditional_mnist` cfm and otcfm (sinkhorn
           inside the graph), each eager, graphed, eager, graphed, eager
           (TG_STEPS steps; graphed within twice the eager runs' spread);
           fp32 under cuDNN's deterministic algorithms, bitwise (loss and
           gradient-norm traces, parameters, Adam moments, EMA): the 64px
           config at reduced depth (num_res_blocks 1, batch TG_FP32_BATCH)
           with its amortized chain sampled from the live model before and
           after the steps (captured again, equal after graphed and eager
           steps), the same with `use_checkpoint` at dropout 0 and
           TG_DROPOUT (also against the plain graphed run), and the
           protein config at batch 32 through `fit` and through
           `fit_scanned` eager at chunk 10 and graphed at chunks 10 and 5,
           and with `--remat` at drop TG_DROPOUT (also against the plain
           graphed run at that drop); the in-step exact OT loss declared
           eager; C6 (the
           fused-QKV attention's gradient against the plain version's in
           bf16 and fp32, and the CIFAR CFM UNet with attention_impl
           "fused" trained graphed at batch 64, its qkv weights moved);
           the EMA body against the eager blend bitwise. Each line: wall
           ms per step (median, quartiles; steady steps), each replay's
           device ms, the card's idle share graphed and eager, capture
           seconds, pool bytes, launches per replay against an eager
           step's, and the route with its reason.
The Stable Diffusion 2 inpainting UNet (`models/ldm_unet.py`, published
widths, random weights from seed 0; `--xattn` runs it alone):
  xattn    the cross-attention kernel (`flash_cross_attention`) against its
           plain version at the 16 (heads, Tq) shapes of an SD2 step at 8
           rows with Tk = 77, and off them; two calls bitwise; times as in
           `kernel`, SDPA as the library yardstick, beside its bound;
  layernorm  the LayerNorm kernel (`kernels/layernorm.py`) against its
           plain version at the 4 [rows, C] shapes of an SD2 step's 48
           calls, bf16, and off them; two calls bitwise; times with L2 warm
           and from a ring of copies larger than L2, the plain version's
           and `F.layer_norm` in bf16, beside the bytes bound;
  xattn_gn  the GroupNorm kernel at the UNet's (C, H*W, eps, act) shapes
           against the plain version;
  xattn_chain  the graphed guided DDIM-50 chain (guidance 7.5, 8 rows a
           step) bitwise against the eager chain, 16 cross- and 16
           self-attention and 48 LayerNorm launches a replay of its step.
FLUX.1 Fill [dev]'s transformer (`models/flux.py`, published widths,
random weights from seed 0; `--flux` runs it alone):
  flux_flash  the flash forward at the joint attention's [24,4608,128]
           (route "mma", 57 calls a step) against its plain version; two
           calls bitwise; times as in `kernel`, SDPA as the library
           yardstick, beside its bound;
  flux_chain  the graphed Fill Euler chain on the shifted sigma grid
           bitwise against the eager chain, at 1 + 2 blocks (4 steps) and
           at the whole 19 + 38 (2 steps), and a second graphed chain with
           the launch counters reset before it: no launch from Python, 3
           and 57 flash forwards a replay.
Then the kernel table line (`launches`: the wrappers' calls on the paths,
a graphed chain's at its warm-up and capture; `replayed_launches`: the
launches replayed from graphs), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits nonzero before that line.
Needs one CUDA card; imports nothing of JAX.

    python3 chip_smoke.py --kernels

builds the kernels and runs only the kernels' cases of the `kernel`,
`resblock_kernel`, `flash_kernel`, `gn_backward`, `xattn`, `xattn_gn` and
`flux_flash` phases, at the shapes the paths give them (`ATTN_PATH_SHAPES`,
`GN_PATH_SHAPES`, `RES_PATH_SHAPES`, `FLASH_PATH_SHAPES`, checked against
the models' own calls in the full run; `XATTN_PATH_SHAPES`; the SD2
UNet's own GroupNorm calls; `FLUX_FLASH_SHAPE`);
a quick check while working on a kernel; it does not print the ok line).

    python3 chip_smoke.py --data-parallel

needs DP_RANKS cards: builds the kernels, then runs the 64px fp32 config at
reduced depth over a (data DP_RANKS x model 1) mesh of one NCCL world, one
rank per card, eager then graphed (the gradients' and loss's all-reduce
captured in each rank's graph): phase `data_parallel`, one line per rank,
bitwise against the eager run, and every rank holding the same parameters
and losses. It does not print the ok line.
"""

import copy
import json
import math
import subprocess
import sys
import time

from benchmark.counts.bounds import (BF16_FLOPS, FP32_FLOPS,
                                     HBM_BYTES_PER_S, bound_s)

BATCH = 64
STEPS = 100
REUSE = 3
REPEATS = 1  # timed eager chains per configuration (graphed: phase graphs)
SEED = 0
# the JAX bench's model (bench.py:114-119)
BENCH_MODEL = dict(image_size=32, num_channels=128, num_res_blocks=2,
                   in_channels=3, channel_mult=(1, 2, 2, 2), num_heads=4,
                   attention_resolutions="16", use_scale_shift_norm=True)
# what the two paths give the attention kernels per forward (checked against
# the models' own calls in the full run): {call shape: calls}
ATTN_PATH_SHAPES = {((BATCH, 256, 768), 4): 5, ((BATCH, 16, 768), 4): 1}
FLASH_PATH_SHAPES = {(128, 1024, 64): 5, (32, 1024, 64): 5}
# the synthetic256 4x super-resolution wrapper's parameter count, the JAX
# package's (tests/test_torch_cfm_conditional.py takes it by jax.eval_shape)
SR256_PARAMS = 125375107
# the GroupNorm calls of one CIFAR forward with norm_impl="fused":
# {(x shape, groups, FiLM, act): calls}
GN_PATH_SHAPES = {
    ((BATCH, h, h, c), 32, film, act): n for h, c, film, act, n in [
        (4, 256, False, "none", 1), (4, 256, False, "silu", 4),
        (4, 256, True, "silu", 7), (4, 512, False, "silu", 3),
        (8, 256, False, "silu", 2), (8, 256, True, "silu", 5),
        (8, 512, False, "silu", 3), (16, 128, False, "silu", 1),
        (16, 256, False, "none", 5), (16, 256, False, "silu", 1),
        (16, 256, True, "silu", 5), (16, 384, False, "silu", 1),
        (16, 512, False, "silu", 2), (32, 128, False, "silu", 3),
        (32, 128, True, "silu", 5), (32, 256, False, "silu", 2),
        (32, 384, False, "silu", 1)]}
# the GroupNorm calls of one 64px training step (cli.main's flowers UNet,
# batch 32, norm_impl="fused" as cli.build takes it on the card), each with
# its backward: {(H = W, C, FiLM, act): calls}
GN_STEP_64PX = {
    (h, c, film, act): n for h, c, film, act, n in [
        (8, 384, False, "silu", 1), (8, 512, False, "none", 6),
        (8, 512, False, "silu", 3), (8, 512, True, "silu", 7),
        (8, 896, False, "silu", 1), (8, 1024, False, "silu", 2),
        (16, 256, False, "silu", 1), (16, 384, False, "none", 5),
        (16, 384, False, "silu", 1), (16, 384, True, "silu", 5),
        (16, 640, False, "silu", 1), (16, 768, False, "silu", 1),
        (16, 896, False, "silu", 1), (32, 128, False, "silu", 1),
        (32, 256, False, "none", 5), (32, 256, False, "silu", 1),
        (32, 256, True, "silu", 5), (32, 384, False, "silu", 1),
        (32, 512, False, "silu", 1), (32, 640, False, "silu", 1),
        (64, 128, False, "silu", 3), (64, 128, True, "silu", 5),
        (64, 256, False, "silu", 2), (64, 384, False, "silu", 1)]}
TRAIN_BATCH = 32
# the 64px UNet's parameters (benchmark config flowers64-unet) and the EMA
# blends of its training cell: one update in ADAM_BLEND_EVERY blends
ADAM_PARAMS = 93_347_587
ADAM_TENSORS = 368
ADAM_BLEND_EVERY = 10
# the ResBlocks of one CIFAR forward: {(x shape, Cout, 1x1 skip): calls}; the
# engine puts those of at least 1024 pixels (the five 32x32 ones) on the
# ResBlock kernel
RES_PATH_SHAPES = {
    ((BATCH, h, h, cin), cout, skip): n for h, cin, cout, skip, n in [
        (4, 256, 256, False, 4), (4, 512, 256, True, 3),
        (8, 256, 256, False, 2), (8, 512, 256, True, 3),
        (16, 128, 256, True, 1), (16, 256, 256, False, 1),
        (16, 384, 256, True, 1), (16, 512, 256, True, 2),
        (32, 128, 128, False, 2), (32, 256, 128, True, 2),
        (32, 384, 128, True, 1)]}
# the 64px UNet's first 64x64 ResBlock (FiLM, identity skip), batch 32: timed
# beside the path shapes, not part of any path
RES_64PX_SHAPE = (32, 64, 128, 128)


def card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"torch_name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


T0 = time.perf_counter()


def emit(card_info, **fields):
    """One JSON line: the fields, the card, and the seconds since the
    script started (`elapsed_s`, which places each phase in the run)."""
    print(json.dumps({**fields, "card": card_info,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


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
    """`benchmark/counts/bounds.py:bound_s` in ms, and the term that
    binds."""
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / op_rate
          else "operations")
    return bound_s(nbytes, ops, op_rate) * 1e3, by


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
    skip (tpu_diffusion/kernels/resblock.py:292). At bf16 it is
    `benchmark/counts/bounds.py:resblock`, which takes no other rate: an
    fp32 call's operations go at `op_rate`."""
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
    gives it, plus an fp32, an additive-mode and an identity-skip case, and
    the 64px UNet's first ResBlock (no path runs it); each line
    names the route and whether two calls agree bitwise. Returns {kernel:
    per-forward sums}."""
    from tpu_diffusion_torch.kernels import resblock
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [(shape[0], shape[1], shape[3], cout, True, skip, bf16, count)
             for (shape, cout, skip), count in sorted(res_shapes.items())
             if shape[1] * shape[2] >= min_tokens]
    cases += [(8, 32, 128, 128, True, False, fp32, 0),
              (8, 32, 256, 128, False, True, bf16, 0),   # additive mode
              (8, 16, 256, 256, True, False, bf16, 0),   # identity skip
              (*RES_64PX_SHAPE, True, False, bf16, 0)]
    tot = dict(max_abs_err=0.0, bound_ms=0.0, by={})
    for b, hw, cin, cout, film, skip, dtype, count in cases:
        args = resblock_inputs(torch, gen, dev, b, hw, cin, cout, film, skip,
                               dtype)
        route = resblock.resblock_route(b, hw, hw, cin, cout, dtype)[0]
        got = resblock.fused_resblock(*args)
        again = resblock.fused_resblock(*args)
        want = resblock.resblock_reference(*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
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
        # no atomics on any route: two calls are bitwise equal
        check(bitwise, f"resblock {b, hw, cin, cout} {dtype}: two calls "
                       f"differ")
        check(not count or route == "wgmma",
              f"resblock {b, hw, cin, cout}: a path shape on the {route!r} "
              f"route")
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
             dtype=str(dtype), route=route, bitwise_twice=bitwise,
             count_per_forward=count, max_abs_err=err,
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
              ((4, 4, 4, 512), 32, False, "none", torch.float32, 0),
              ((4, 32, 32, 384), 32, True, "silu", torch.float32, 0),
              # off the path: an image too large for a cluster's shared
              # memory, on the two-pass route
              ((2, 64, 64, 512), 32, True, "silu", torch.float32, 0)]
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
        route, geometry = groupnorm.gn_route(
            b, h * w, c, x.element_size(), groups,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        got = groupnorm.fused_groupnorm_silu(*args)
        again = groupnorm.fused_groupnorm_silu(*args)
        want = groupnorm.reference_groupnorm_silu(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(math.isfinite(err) and err <= gn_tol[dtype],
              f"groupnorm {b, h, w, c} {dtype} film={film}: max abs err "
              f"{err}")
        # the partials are summed in a fixed order on both routes
        same = torch.equal(got, again)
        check(same, f"groupnorm {b, h, w, c} {dtype}: two calls differ")
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
             dtype=str(dtype), route=route, geometry=list(geometry),
             count_per_forward=count, max_abs_err=err, tol=gn_tol[dtype],
             two_calls_bitwise_equal=same, **times, bound_ms=bnd,
             bound_by=by)
        if count:
            add("fused_groupnorm_silu", count, err, times, bnd, by)
    return totals


def gn_backward_phase(torch, F, card_info, shapes=GN_STEP_64PX,
                      batch=TRAIN_BATCH):
    """The GroupNorm backward kernel (no TPU counterpart: the JAX kernel has
    no backward; added so that the trained UNet can take the kernel pair)
    at the 64px training step's shapes, bf16: dx, dgamma, dbeta, dscale,
    dshift against autograd through the plain version in fp32; two calls
    bitwise equal; its device time beside its bound (bytes: read x and dy,
    write dx, the fp32 parameters and their gradients, with FiLM the
    [B, C] scale, shift and their gradients, the statistics); the other
    route's time where the shape has two; and, forward and backward
    through autograd, the kernel pair against the UNet's plain chain
    (GroupNorm32: `F.group_norm` on an fp32 copy, the bf16 cast and the
    channels_last copy, FiLM, SiLU) and against `F.group_norm` in bf16 with
    FiLM and SiLU (the library yardstick). Returns {kernel: per-step
    sums}."""
    from tpu_diffusion_torch.kernels import groupnorm
    from tpu_diffusion_torch.models import nn as nn_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dtype, groups = torch.bfloat16, 32
    tot = dict(max_rel_err=0.0, bound_ms=0.0, by={})
    for (h, c, film, act), count in sorted(shapes.items()):
        b = batch
        x = (torch.randn((b, h, h, c), generator=gen, device=dev) * 2
             + 0.5).to(dtype)
        dy = torch.randn((b, h, h, c), generator=gen, device=dev).to(dtype)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        emb = scale = shift = None
        if film:
            emb = (0.2 * torch.randn((b, 2 * c), generator=gen, device=dev)
                   ).to(dtype)
            scale, shift = emb[:, :c], emb[:, c:]
        stats = torch.empty((b, groups, 2), device=dev)
        with torch.no_grad():
            groupnorm._launch(x, gamma, beta, scale, shift, groups, 1e-5, act,
                              stats=stats)
        args = (dy, x, gamma, beta, scale, shift, stats, groups, act)
        route = groupnorm.gn_bwd_route(b, h * h, c, 2, groups, sms)
        got = groupnorm._launch_backward(*args)
        again = groupnorm._launch_backward(*args)
        leaves = [None if t is None else t.detach().float().requires_grad_()
                  for t in (x, gamma, beta, scale, shift)]
        groupnorm.reference_groupnorm_silu(*leaves, groups, act=act).backward(
            dy.float())
        torch.cuda.synchronize()
        errs = [((g.float() - w.grad).abs().max() / w.grad.abs().max()).item()
                for g, w in zip(got, leaves) if w is not None]
        err = max(errs)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again)
                   if a is not None)
        check(math.isfinite(err) and err <= 1e-2,
              f"groupnorm backward {b, h, h, c} film={film} {act}: largest "
              f"error {err} of the largest entry")
        check(same, f"groupnorm backward {b, h, h, c}: two calls differ")
        del leaves
        times = {}
        times["ms"], times["eager_ms"] = time_ms(
            lambda: groupnorm._launch_backward(*args))
        # the other route, where the shape has two (BWD_CLUSTER_MAX moved)
        if groupnorm.bwd_cluster_route(b, h * h, c, 2, groups, sms):
            other = "two_pass" if route[0] == "cluster" else "cluster"
            was = groupnorm.BWD_CLUSTER_MAX
            groupnorm.BWD_CLUSTER_MAX = 0 if other == "two_pass" else 1 << 40
            try:
                times[other + "_ms"], _ = time_ms(
                    lambda: groupnorm._launch_backward(*args))
            finally:
                groupnorm.BWD_CLUSTER_MAX = was
        # forward and backward through autograd, in the UNet's NCHW
        # channels_last layout: the kernel pair (FusedNormAct), the plain
        # chain (GroupNorm32 + FiLM + SiLU), F.group_norm in bf16
        x_cl = x.permute(0, 3, 1, 2)
        x_nchw = x_cl.contiguous()
        dy_cl = dy.permute(0, 3, 1, 2)
        fused = nn_mod.FusedNormAct(c, act=act, device=dev)
        plain = nn_mod.GroupNorm32(c, device=dev)
        g16 = gamma.to(dtype).requires_grad_()
        b16 = beta.to(dtype).requires_grad_()
        for m in (fused, plain):
            with torch.no_grad():
                m.weight.copy_(gamma)
                m.bias.copy_(beta)
        emb_g = emb.clone().requires_grad_() if film else None
        xg = x_cl.detach().requires_grad_()
        xn = x_nchw.detach().requires_grad_()

        def film_act(y, e):
            if e is not None:
                y = y * (1 + e[:, :c, None, None]) + e[:, c:, None, None]
            return F.silu(y) if act == "silu" else y

        def through(fwd, inputs):
            def run():
                outs = [t for t in inputs if t is not None]
                return torch.autograd.grad(fwd(), outs, dy_cl)
            return run

        times["autograd_ms"], times["autograd_eager_ms"] = time_ms(through(
            lambda: fused(xg, film=emb_g),
            [xg, fused.weight, fused.bias, emb_g]))
        times["plain_ms"], times["plain_eager_ms"] = time_ms(through(
            lambda: film_act(plain(xg), emb_g),
            [xg, plain.weight, plain.bias, emb_g]))
        times["library_ms"], times["library_eager_ms"] = time_ms(through(
            lambda: film_act(F.group_norm(xn, groups, g16, b16, 1e-5),
                             emb_g), [xn, g16, b16, emb_g]))
        n = b * h * h * c
        nbytes = (3 * n * 2 + 4 * c * 4 + (4 * b * c * 2 if film else 0)
                  + b * groups * 8)
        # ~24 fp32 operations per element: xhat, z, SiLU and its slope, the
        # two sums, dx
        bnd, by = bound_ms(nbytes, 24 * n, FP32_FLOPS)
        emit(card_info, phase="gn_backward", kernel="fused_groupnorm_silu_bwd",
             shape=[b, h, h, c], groups=groups, film=film, act=act,
             dtype=str(dtype), route=route[0], geometry=list(route[1]),
             count_per_step=count, max_rel_err=err, tol=1e-2,
             two_calls_bitwise_equal=same, **times, bound_ms=bnd,
             bound_by=by, roofline=bnd / times["ms"])
        tot["max_rel_err"] = max(tot["max_rel_err"], err)
        tot["bound_ms"] += count * bnd
        tot["by"][by] = tot["by"].get(by, 0.0) + count * bnd
        for k, v in times.items():
            if k not in ("two_pass_ms", "cluster_ms"):
                tot[k] = tot.get(k, 0.0) + count * v
        del fused, plain, x, dy, got, again
    tot["max_abs_err"] = None  # relative: max_rel_err
    emit(card_info, phase="gn_backward", per_step={
        k: v for k, v in tot.items() if k != "by"},
         roofline=tot["bound_ms"] / tot["ms"],
         note="sums over the 61 calls of one 64px training step at batch "
              "32; ms: the backward kernel alone; autograd_ms: forward and "
              "backward through FusedNormAct; plain_ms: through "
              "GroupNorm32 + FiLM + SiLU (norm_impl='plain'); library_ms: "
              "F.group_norm in bf16 + FiLM + SiLU; device time from CUDA "
              "graph replay, eager_* launched from Python")
    return {"fused_groupnorm_silu_bwd": tot}


def adam_phase(torch, card_info):
    """The fused clip + Adam + EMA kernel (`kernels/adam.py`; no TPU
    counterpart: XLA fuses optax's update inside the JAX package's jitted
    step) at the parameters of `cli.build`'s 64px UNet (ADAM_TENSORS
    tensors, ADAM_PARAMS fp32 values). One update with the clip engaged
    and the EMA blended against the plain version on copies on the card,
    bitwise.
    Device times (CUDA-graph replay) of: the kernel on a step that keeps
    the EMA (d = 1: 28 bytes an element) and on one that blends it (36),
    beside their bytes bounds; the optimizer's whole update (the global
    norm, the clip factor and the kernel, as the step's `update_ms.train`
    spans it) on the "fused" route and on the "foreach" route (the norm
    and the fourteen `_foreach_` passes); the foreach chain alone ("plain":
    what the kernel replaces); `torch.optim.Adam(fused=True,
    capturable=True)` on copies, Adam alone without clip or EMA (the
    library yardstick). Gradients under the clip, so that the foreach
    chain's in-place clip leaves them as they are from repeat to repeat.
    Returns {kernel: totals} for the kernel table."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.core.ema import EMAState
    from tpu_diffusion_torch.kernels import adam
    from tpu_diffusion_torch.train import trainer
    from tpu_diffusion_torch.utils import config as config_mod
    dev = torch.device("cuda")
    config = config_mod.get_config("flowers,inpainting,amortized")
    config.network.model_path = ""
    torch.manual_seed(SEED)
    model = cli.build(config, dev)["model"]
    named = dict(model.named_parameters())
    params = list(named.values())
    n = sum(p.numel() for p in params)
    check(len(params) == ADAM_TENSORS and n == ADAM_PARAMS,
          f"the 64px UNet has {len(params)} tensors, {n} parameters")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ramp = 2.0 / 11.0
    f32 = dict(dtype=torch.float32, device=dev)
    lr, bc1, bc2 = (torch.tensor(v, **f32) for v in
                    (1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3))
    decay, rest = torch.tensor(ramp, **f32), torch.tensor(1 - ramp, **f32)
    # -- one update against the plain version, bitwise ------------------
    p = [t.detach().clone() for t in params]
    g = [torch.randn(t.shape, generator=gen, device=dev) for t in params]
    m = [0.1 * torch.randn(t.shape, generator=gen, device=dev) for t in p]
    v = [torch.rand(t.shape, generator=gen, device=dev) for t in p]
    e = [t + 0.01 for t in p]
    norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
    clip = 1.0 / torch.clamp(norm, min=1.0)
    ref = [[t.clone() for t in ts] for ts in (p, g, m, v, e)]
    tables = adam.Tables()
    adam.fused_adam_ema(p, g, m, v, e, lr, bc1, bc2, clip, decay, rest,
                        tables=tables)
    adam.adam_ema_reference(*ref, lr, bc1, bc2, clip, decay, rest)
    torch.cuda.synchronize()
    diff = 0.0
    same = True
    for got, want in zip((p, m, v, e), (ref[0], ref[2], ref[3], ref[4])):
        for a, b in zip(got, want):
            same = same and torch.equal(a, b)
            diff = max(diff, float((a - b).abs().max()))
    check(same and float(clip) < 1.0,
          f"fused_adam_ema differs from its plain version (max |diff| "
          f"{diff}) or the clip did not engage ({float(clip)})")
    del ref
    # -- device times ---------------------------------------------------
    for t in g:
        t.mul_(1e-5)  # global norm ~ 0.1: under the clip
    clip.fill_(1.0)
    times = {}
    for mode, d in (("keep", 1.0), ("blend", ramp)):
        decay.fill_(d)
        rest.fill_(1.0 - d)
        times[mode], times[mode + "_eager"] = time_ms(
            lambda: adam.fused_adam_ema(p, g, m, v, e, lr, bc1, bc2, clip,
                                        decay, rest, tables=tables))

    class Foreach(trainer.Optimizer):
        route = "foreach"

    for t, grad in zip(params, g):
        t.grad = grad
    ema = EMAState(named)
    opts = {"fused": trainer.make_optimizer(params, 1e-4),
            "foreach": Foreach(params, trainer.make_schedule(1e-4))}
    check(opts["fused"].route == "fused", "the 64px UNet's optimizer takes "
          f"the {opts['fused'].route!r} route")
    for opt in opts.values():
        opt.fill()
        opt.blend(ema, named)
    update = {}
    for mode, d in (("keep", 1.0), ("blend", ramp)):
        ema.decay.fill_(d)
        ema.rest.fill_(1.0 - d)
        for route, opt in opts.items():
            update[f"{route}_{mode}"], _ = time_ms(opt.update)
        fe = opts["foreach"]
        mu = [fe.state[t]["exp_avg"] for t in params]
        nu = [fe.state[t]["exp_avg_sq"] for t in params]

        @torch.no_grad()
        def chain():
            fe._foreach(params, g, mu, nu, clip)

        times["plain_" + mode], times[f"plain_{mode}_eager"] = time_ms(chain)
    norm_ms, _ = time_ms(lambda: trainer.global_norm(params))
    lib_params = [t.detach().clone().requires_grad_() for t in params]
    for t, grad in zip(lib_params, g):
        t.grad = grad
    library = torch.optim.Adam(lib_params, lr=1e-4, fused=True,
                               capturable=True)
    library_ms, library_eager_ms = time_ms(library.step)
    for t in params:
        t.grad = None
    bound = {mode: nbytes * n / HBM_BYTES_PER_S * 1e3
             for mode, nbytes in (("keep", 28), ("blend", 36))}
    norm_bound = 4 * n / HBM_BYTES_PER_S * 1e3
    k = ADAM_BLEND_EVERY

    def per_step(x):  # the cell's mix: one blend in k updates
        return ((k - 1) * x["keep"] + x["blend"]) / k

    emit(card_info, phase="adam", kernel="fused_adam_ema",
         tensors=len(params), params=n, bitwise_vs_plain=same,
         max_abs_diff=diff, ms_keep=times["keep"], ms_blend=times["blend"],
         eager_ms_keep=times["keep_eager"],
         bound_ms_keep=bound["keep"], bound_ms_blend=bound["blend"],
         roofline_keep=bound["keep"] / times["keep"],
         roofline_blend=bound["blend"] / times["blend"],
         plain_ms_keep=times["plain_keep"],
         plain_ms_blend=times["plain_blend"], global_norm_ms=norm_ms,
         global_norm_bound_ms=norm_bound,
         update_ms=update,
         update_ms_per_step={
             route: per_step({"keep": update[route + "_keep"],
                              "blend": update[route + "_blend"]})
             for route in opts},
         update_bound_ms_per_step=per_step(bound) + norm_bound,
         library_ms=library_ms, library_eager_ms=library_eager_ms,
         note="ms: the kernel alone; update_ms: Optimizer.update with the "
              "EMA bound (global norm, clip factor, then the kernel or the "
              "foreach chain and ema_blend); plain_ms: the foreach chain "
              "and ema_blend alone; per_step: the training cell's mix of "
              f"{k - 1} keeps to 1 blend; library_ms: "
              "torch.optim.Adam(fused=True, capturable=True), Adam alone; "
              "bounds: bytes at 3.35 TB/s; device time from CUDA-graph "
              "replay (eager_*: launched from Python)")
    del library, lib_params, opts, ema, p, g, m, v, e
    torch.cuda.empty_cache()
    return {"fused_adam_ema": dict(
        max_abs_err=diff, ms=per_step(times), bound_ms=per_step(bound),
        by={"bytes": per_step(bound)}, eager_ms=times["keep_eager"],
        plain_ms=per_step({"keep": times["plain_keep"],
                           "blend": times["plain_blend"]}),
        plain_eager_ms=times["plain_keep_eager"], library_ms=library_ms,
        library_eager_ms=library_eager_ms)}


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
# the amortized chains (config diffusion.num_steps), cut from 1000 to keep
# the run short; the graphed chains per step: phase graphs
COND_STEPS = 250
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
              ((8, 520, 128), torch.bfloat16, 0),
              # the TMA / `wgmma` forward at one tile and at T = 2048
              ((4, 128, 64), torch.bfloat16, 0),
              ((8, 2048, 64), torch.bfloat16, 0)]
    for (bh, t, d), dtype, count in cases:
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        name = str(dtype).split(".")[-1]
        # forward: o in the inputs' type (tolerance: `flash_o_tol`), lse
        # fp32 on both sides (1e-4 for values ~10: the order of the sums)
        route = attention.flash_fwd_route(bh, t, d, dtype)
        o, lse = attention.flash_attention_fwd(q, k, v)
        o2, lse2 = attention.flash_attention_fwd(q, k, v)
        want_o, want_lse = attention.flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        tol = flash_o_tol(name, want_o)
        err_o = (o.float() - want_o.float()).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        check(math.isfinite(err_o) and err_o <= tol and err_lse <= 1e-4,
              f"flash forward {bh, t, d} {name}: o err {err_o}, lse err "
              f"{err_lse}")
        # no forward route sums with atomics: two calls agree bitwise
        fwd_same = torch.equal(o, o2) and torch.equal(lse, lse2)
        check(fwd_same, f"flash forward {bh, t, d} {name}: two calls differ")
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
                 {"max_abs_err_lse": err_lse, "tol": tol, "route": route,
                  "two_calls_bitwise_equal": fwd_same}),
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


def flash_shapes(net, batch):
    """{(batch * heads, T, d): calls} of the flash blocks in `net`'s last
    forward, from its decision log."""
    shapes = {}
    for n, d in net.attn_decisions.items():
        if d["impl"] == "flash":
            c = getattr(net, n).qkv.in_features
            key = (batch * d["heads"], d["tokens"], c // d["heads"])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def sr256_flash_shapes(torch, dev):
    """The flash calls of one forward of the synthetic256 super-resolution
    wrapper (`train_cfm_conditional.build`, full width, batch SR_BATCH,
    random weights): its 32x32 blocks on the flash path, the others dense."""
    from tpu_diffusion_torch.cli import train_cfm_conditional as cc
    from tpu_diffusion_torch.models import unet
    model, (h, w, c) = cc.build("superres", "synthetic256", device=dev)
    unet.randomize_(model, torch.Generator().manual_seed(SEED)).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn((SR_BATCH, h, w, c), generator=gen, device=dev)
    low = torch.randn((SR_BATCH, h // 4, w // 4, c), generator=gen,
                      device=dev)
    with torch.no_grad():
        model(torch.full((SR_BATCH,), 0.5, device=dev), x, low)
    decisions = model.net.attn_decisions
    flash = sorted(n for n, d in decisions.items() if d["impl"] == "flash")
    check(flash == ["dec_attn_3_0", "dec_attn_3_1", "dec_attn_3_2",
                    "enc_attn_3_0", "enc_attn_3_1"]
          and all(decisions[n]["tokens"] == 1024 for n in flash)
          and {d["impl"] for d in decisions.values()} == {"flash", "dense"},
          f"the SR256 wrapper's attention decisions {decisions}")
    shapes = flash_shapes(model.net, SR_BATCH)
    del model
    torch.cuda.empty_cache()
    return shapes


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
        **{"testing.lpips": "false", "diffusion.num_steps": COND_STEPS})
    cfg_g, parts_g, uncond, uncond_plain = cond_models(
        torch, cli, unet, config_mod, dev, spec_g,
        **{"testing.lpips": "false", "diffusion.num_steps": SHORT_STEPS})
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    imgs = torch.from_numpy(
        get_dataset("flowers")("data", train=False).images[:COND_BATCH]
    ).to(dev)
    t = torch.full((COND_BATCH,), 0.5, device=dev)

    # --- full-width forward: kernels against plain versions -------------
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
        # both models make the same flash calls
        path_shapes = flash_shapes(mk, COND_BATCH)
    check(path_shapes == {(128, 1024, 64): 5},
          f"the 64px UNet's flash calls {path_shapes}")
    path_shapes.update(sr256_flash_shapes(torch, dev))
    check(path_shapes == FLASH_PATH_SHAPES,
          f"the 64px UNet's and the SR256 wrapper's flash calls "
          f"{path_shapes}")
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
    config_mod.apply_overrides(cfg_k1, ["testing.encoder_reuse=1",
                                        f"diffusion.num_steps={COND_STEPS}"])
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
        r0 = ran()
        s0 = time.perf_counter()
        out = sampler(model, xT, condition, run_gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        # what ran (graph replays included, warm-ups and captures not)
        r1 = ran()
        got_f = r1["flash_attention_fwd"] - r0["flash_attention_fwd"]
        got_b = r1["flash_attention_bwd"] - r0["flash_attention_bwd"]
        launches["flash_attention_fwd"] += attention.flash_fwd_launches
        launches["flash_attention_bwd"] += attention.flash_bwd_launches
        outs[name] = out
        stats = {k: v.item() for k, v in eval_statistics(out, imgs).items()}
        emit(card_info, phase="sample", run=name, batch=COND_BATCH,
             steps=steps, seconds=seconds,
             samples_per_s=COND_BATCH / seconds,
             ms_per_step=seconds * 1e3 / steps,
             flash_fwd_launches=got_f, flash_fwd_expected=want_f,
             flash_bwd_launches=got_b, flash_bwd_expected=want_b,
             out_min=out.min().item(), out_max=out.max().item(), **stats,
             wrapper_calls=[attention.flash_fwd_launches,
                            attention.flash_bwd_launches],
             note="random weights: the metrics make no quality claim; "
                  "amortized_k3, amortized_plain, guidance and "
                  "outpainting_replacement are graphed chains "
                  "(cli.make_samplers): seconds include their capture, "
                  "*_launches what ran (replays included), wrapper_calls "
                  "the wrappers' counts (warm-ups and captures)"
             + f"; chain cut from 1000 to {steps} steps to keep the run "
               f"short")
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
    from tpu_diffusion_torch.utils.graphs import WARMUP
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
    r0 = ran()
    trainer = Trainer(step_fn, state, batches)  # graphed: the default
    trainer.graphs.events = []
    t0 = time.perf_counter()
    state = trainer.fit(TRAIN_STEPS, metrics_hook=hook)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": attention.flash_fwd_launches,
                "flash_attention_bwd": attention.flash_bwd_launches}
    executed = delta(ran(), r0)
    replays = [a.elapsed_time(b) for a, b in trainer.graphs.events]
    entry, = trainer.graphs.captured().values()
    del trainer
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
             flash_executed=executed, graphed=True,
             replay_device_ms=quartiles(replays),
             launches_per_replay=entry.launches,
             capture_s=entry.capture_s, pool_gb=entry.pool_bytes / 1e9,
             checkpoint_equal=same,
             note="graphed steps (train/graph.py): 2 eager warm-ups, a "
                  "capture, one replay a step after (the eager twin: "
                  "phase train_graphs); ms per step: host clock between "
                  "the per-step metric reads (each a device "
                  "synchronisation), after the first step; "
                  "flash_fwd/bwd_launches: the wrappers' calls (warm-ups "
                  "and capture); flash_executed: what ran (replays "
                  "included); synthetic images; the model's own "
                  "initialisation from the seed")
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
        per_step = {"flash_attention_fwd": 5, "flash_attention_bwd": 5,
                    "fused_groupnorm_silu": 61,
                    "fused_groupnorm_silu_bwd": 61, "fused_adam_ema": 1}
        check(executed == {k: v * TRAIN_STEPS for k, v in per_step.items()}
              and entry.launches == per_step
              and entry.replays == TRAIN_STEPS - WARMUP,
              f"train: flash launches {executed}, per replay "
              f"{entry.launches}, {entry.replays} replays")
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


FEATURE_TOL = 1e-4  # relative, fp32 card against fp32 CPU


def rel_err(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().abs().max()).item()


def eval_metrics_phase(torch, card_info, dev):
    """`cli.main --mode eval` with LPIPS and FID on the 64px flowers config
    (its full width, random weights from SEED, a 50-step chain), the metrics'
    own checks, and the three feature networks on the card against the CPU.
    Returns the flash forward's launches in the eval run."""
    import shutil
    import tempfile

    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.data.registry import get_dataset
    from tpu_diffusion_torch.eval import fid, lpips
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.models import unet
    from tpu_diffusion_torch.sampling import ancestral
    from tpu_diffusion_torch.train.checkpoint import CheckpointManager
    from tpu_diffusion_torch.utils import config as config_mod
    spec = "flowers,inpainting,amortized"
    overrides = ["testing.lpips=true", "testing.fid=true",
                 "testing.fid_features=random_conv",
                 f"testing.num_test={COND_BATCH}",
                 f"testing.batch_size={COND_BATCH}",
                 f"diffusion.num_steps={SHORT_STEPS}"]
    config = config_mod.get_config(spec)
    config_mod.apply_overrides(config, overrides)
    parts = cli.build(config, dev)
    model = unet.randomize_(parts["model"],
                            torch.Generator().manual_seed(SEED)).eval()
    imgs = torch.from_numpy(get_dataset("flowers")("data", train=False)
                            .images[:COND_BATCH]).to(dev)

    # one batch's sampler chain, as run_eval calls it (host clock)
    cond_sample, _ = cli.make_samplers(config, parts)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    condition = parts["likelihood"].sample(gen, imgs)
    xT = torch.randn(imgs.shape, generator=gen, device=dev)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    cond_sample(model, xT, condition, gen)
    torch.cuda.synchronize()
    sampler_ms = (time.perf_counter() - s0) * 1e3

    workdir = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        params = {k: v.detach() for k, v in model.named_parameters()}
        CheckpointManager(f"{workdir}/ckpt").save(
            1, {"params": params, "ema": params, "step": 1})
        del parts, model, params, cond_sample
        torch.cuda.empty_cache()
        args = ["--config", spec, "--mode", "eval", "--workdir", workdir,
                "--device", dev.type]
        for o in overrides:
            args += ["--override", o]
        torch.cuda.synchronize()
        attention.flash_fwd_launches = 0
        r0 = ran()
        s0 = time.perf_counter()
        results = cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        launches = attention.flash_fwd_launches
        # the graphed chain's: replays included, warm-ups and captures not
        chain_launches = (ran()["flash_attention_fwd"]
                          - r0["flash_attention_fwd"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # the amortized K=3 chain: one encoder pass (2 flash blocks) per reuse
    # group, a decoder pass (3) per step
    want = (2 * len(ancestral.reuse_groups(range(SHORT_STEPS), COND_REUSE))
            + 3 * SHORT_STEPS)

    # the metrics' own checks: LPIPS of an image against itself, FID of the
    # real set's statistics against themselves
    lpips_fn = cli._get_lpips(dev)
    self_lpips = lpips_fn(imgs, imgs).abs().max().item()
    (feature_fn, (mu, sigma), _), = cli._FID_REAL_CACHE.values()
    s0 = time.perf_counter()
    self_fid = fid.frechet_distance(mu, sigma, mu, sigma)
    frechet_seconds = time.perf_counter() - s0

    # device time per eval batch of each feature network
    other = torch.flip(imgs, dims=[0])
    inception_fn = fid.make_feature_fn("inception_random", device=dev)
    times = {}
    for name, fn in (("random_conv", lambda: feature_fn(imgs)),
                     ("lpips_vgg", lambda: lpips_fn(imgs, other)),
                     ("inception", lambda: inception_fn(imgs))):
        times[name + "_ms"], times[name + "_eager_ms"] = time_ms(fn, iters=3)

    # each feature network on the card against the same module on the CPU
    x, y = imgs[:4], other[:4]
    errs = {
        "random_conv": rel_err(
            feature_fn(x),
            fid.make_feature_fn("random_conv", device="cpu")(x.cpu())),
        "lpips_vgg": rel_err(
            lpips_fn(x, y),
            lpips.PerceptualDistance(device="cpu")(x.cpu(), y.cpu())),
        "inception": rel_err(
            inception_fn(x),
            fid.make_feature_fn("inception_random", device="cpu")(x.cpu()))}
    del inception_fn
    torch.cuda.empty_cache()
    emit(card_info, phase="eval_metrics", config=spec, overrides=overrides,
         seconds=seconds, lpips=results.get("lpips"),
         fid=results.get("fid"),
         fid_comparable_to_published=results.get(
             "fid_comparable_to_published"),
         fid_features=results.get("fid_features"),
         num_images=results.get("num_images"),
         mse_mean=results.get("mse_mean"),
         flash_fwd_launches=chain_launches, flash_fwd_expected=want,
         flash_fwd_wrapper_calls=launches,
         sampler_ms_per_batch=sampler_ms, **times,
         frechet_distance_seconds=frechet_seconds,
         self_lpips_max=self_lpips, self_fid=self_fid,
         card_vs_cpu_rel_err=errs, tol=FEATURE_TOL,
         precision="feature networks in fp32 with TF32 off "
                   "(eval/fid.py:full_fp32)",
         note="random weights (UNet from the seed; LPIPS and FID features "
              "from fixed torch seeds): no quality claim; sampler: one "
              f"{SHORT_STEPS}-step K=3 chain of batch {COND_BATCH}, host "
              "clock; feature networks: device time per batch of "
              f"{COND_BATCH} (CUDA graph) and eager; frechet_distance: "
              "host seconds of one 2048-wide FID; card_vs_cpu: max "
              "|card - cpu| / max |cpu| over 4 images")
    check(results["num_images"] == COND_BATCH
          and all(math.isfinite(results[k]) for k in ("lpips", "fid"))
          and results["fid_comparable_to_published"] is False,
          f"eval_metrics: results {results}")
    check(chain_launches == want, f"eval_metrics: flash launches "
                                  f"{chain_launches}, want {want}")
    check(self_lpips == 0.0, f"eval_metrics: LPIPS(x, x) = {self_lpips}")
    check(abs(self_fid) <= 1e-3, f"eval_metrics: FID(real, real) = "
                                 f"{self_fid}")
    check(all(e <= FEATURE_TOL for e in errs.values()),
          f"eval_metrics: card against CPU {errs}")
    return launches


CFM_TRAIN_STEPS = 20


class Trace(list):
    """(seconds, loss, flash forward launches, flash backward launches) per
    step, `replays`: the (start, end) CUDA events of every graph replay of
    the steps, and `route`: the Trainer's route line."""

    def __init__(self):
        super().__init__()
        self.replays = []
        self.route = None


class TimedTrainer:
    """Swap `module.Trainer` for a subclass whose `fit` reads the metrics
    after every step (a device synchronisation) and stamps the host clock
    and the flash kernels' launches that ran since the Trainer was built
    (`ran()`: the graphed steps' replays counted, their captures not),
    and whose graphed
    steps time their replays; the `Trace` of (seconds, loss, flash forward
    launches, flash backward launches) per step."""

    def __init__(self, module):
        self.module, self.real, self.trace = module, module.Trainer, Trace()
        trace = self.trace
        r0 = {}

        class Timed(module.Trainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                r0.clear()
                r0.update(ran())  # the phase may have reset the counters
                trace.route = self.route()
                if self.graphed:
                    self.graphs.events = trace.replays

            def fit(self, num_steps, metrics_hook=None):
                def hook(step, m):
                    r = delta(ran(), r0)
                    trace.append((time.perf_counter(), m["loss"],
                                  r.get("flash_attention_fwd", 0),
                                  r.get("flash_attention_bwd", 0)))
                return super().fit(num_steps, metrics_hook=hook)

        self.timed = Timed

    def __enter__(self):
        self.module.Trainer = self.timed
        return self.trace

    def __exit__(self, *exc):
        self.module.Trainer = self.real


def replay_ms(torch, trace):
    """The device ms of each graph replay of a `Trace`'s steps."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in trace.replays]


def step_times(t0, trace):
    """(first step's ms, the later steps' ms sorted)."""
    stamps = [t0] + [s for s, *_ in trace]
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return ms[0], sorted(ms[1:])


def cfm_train_phase(torch, card_info, out):
    """CIFAR-10 OT-CFM training through `cli.train_cifar10.main` at the
    config's full width and batch (synthetic CIFAR-10), then 5 I-CFM
    steps. Checkpoints under `out`."""
    import os

    from tpu_diffusion_torch.cli import train_cifar10 as tc
    common = ["--output_dir", out, "--warmup", "5"]
    with TimedTrainer(tc) as trace:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = time.perf_counter()
        last = tc.main(["--model", "otcfm", "--total_steps",
                        str(CFM_TRAIN_STEPS), "--save_step", "10"] + common)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        peak = torch.cuda.max_memory_allocated() / 1e9
        otcfm = list(trace)
        trace.clear()
        tc.main(["--model", "icfm", "--total_steps", "5", "--save_step",
                 "1000"] + common)
        icfm = list(trace)
    _, step_ms = step_times(s0, otcfm)
    losses = [l for _, l, _, _ in otcfm]
    ckpt_dir = os.path.join(out, "otcfm", "ckpt")
    ckpts = sorted(os.listdir(ckpt_dir))
    saved = torch.load(os.path.join(ckpt_dir, ckpts[-1]), map_location="cpu",
                       weights_only=True)
    dtypes = sorted({str(v.dtype) for v in saved["params"].values()})
    grid = last["grid"]
    emit(card_info, phase="cfm_train", model="otcfm", batch=128,
         steps=CFM_TRAIN_STEPS, seconds=seconds,
         ms_per_step_median=step_ms[len(step_ms) // 2],
         ms_per_step_min=step_ms[0], ms_per_step_max=step_ms[-1],
         peak_memory_gb=peak, loss_first=losses[0], loss_last=losses[-1],
         losses=losses, param_dtypes=dtypes,
         n_params=sum(v.numel() for v in saved["params"].values()),
         checkpoints=ckpts, grid_shape=list(grid.shape),
         grid_nfe=last["nfe"], grid_min=grid.min().item(),
         grid_max=grid.max().item(),
         icfm_losses=[l for _, l, _, _ in icfm],
         note="128 channels, (1,2,2,2), attention at 16x16 with 4 heads, "
              "dropout 0.1, bf16 forward, fp32 parameters; exact OT pairs "
              "on the host (prefetch 2); synthetic CIFAR-10; ms per step: "
              "host clock between the per-step metric reads over steps "
              "2-20 (the interval after step 10 holds the checkpoint and "
              "the 64-image Euler-100 grid); seconds: the whole main() "
              "call, data and model set-up included")
    check(len(otcfm) == CFM_TRAIN_STEPS and len(icfm) == 5
          and all(math.isfinite(l) for _, l, _, _ in otcfm + icfm),
          f"cfm_train: losses {losses} {icfm}")
    check(dtypes == ["torch.float32"], f"cfm_train: parameters {dtypes}")
    check(ckpts == ["ckpt_00000010.pt", "ckpt_00000020.pt"]
          and saved["step"] == CFM_TRAIN_STEPS,
          f"cfm_train: checkpoints {ckpts}")
    check(tuple(grid.shape) == (64, 32, 32, 3) and last["nfe"] == 100
          and bool(torch.isfinite(grid).all()) and grid.abs().max() <= 1.0,
          f"cfm_train: grid {tuple(grid.shape)} nfe {last['nfe']}")


def cfm_fid_phase(torch, card_info, out):
    """`cli.compute_fid.main` on the cfm_train checkpoint: random_conv
    features, one batch of 512 images (cut from 1024, to make room for
    the train_graphs phase) by Euler-100, by dopri5 (the early
    exit, graphed) and by the calibrated fixed-trip dopri5 in segments of 8
    trips (`Dopri5Chunked`)."""
    from tpu_diffusion_torch.cli import compute_fid
    common = ["--model", "otcfm", "--input_dir", out, "--features",
              "random_conv", "--num_gen", "512", "--batch_size_fid", "512"]
    runs = {"euler": [], "dopri5": [],  # dopri5 at the default tol 1e-5
            # the calibrated fixed-trip budget in segments of 8 trips
            "dopri5_chunked": ["--dopri5_fixed_trip", "true",
                               "--dopri5_chunk", "8"]}
    for run, extra in runs.items():
        method = run.split("_")[0]
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        res = compute_fid.main(common + ["--integration_method", method]
                               + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - s0
        emit(card_info, phase="cfm_fid", run=run, method=method,
             seconds=seconds, fid=res["fid"], mean_nfe=res["mean_nfe"],
             dopri5_truncated=res.get("dopri5_truncated"),
             dopri5_trip_budget=res.get("dopri5_trip_budget"),
             dopri5_chunk=res.get("dopri5_chunk"),
             tol=res.get("tol"), step=res["step"], num_gen=res["num_gen"],
             peak_memory_gb=res["peak_memory_gb"],
             fid_comparable_to_published=res[
                 "fid_comparable_to_published"],
             fid_note=res.get("fid_note"),
             note="20 training steps: no quality claim; seconds: the whole "
                  "main() call (the first computes the real-set "
                  "statistics, the second reads them from its cache)")
        check(math.isfinite(res["fid"]) and res["step"] == CFM_TRAIN_STEPS
              and res["num_gen"] == 512,
              f"cfm_fid {run}: {res}")
        if method == "euler":
            check(res["mean_nfe"] == 100, f"cfm_fid euler: NFE {res}")
        else:
            check(res["mean_nfe"] > 6 and not res["dopri5_truncated"],
                  f"cfm_fid {run}: {res}")
        if extra:
            check(res["dopri5_chunk"] == 8
                  and res["dopri5_trip_budget"] >= 16,
                  f"cfm_fid {run}: {res}")


# --- dopri5 as a graphed chain on compute_fid's field ---------------------
DOPRI5_BATCH = 128        # the FID protocol's batch 1024, cut
DOPRI5_TOL = 1e-5         # the protocol's rtol = atol
DOPRI5_CHUNK = 8          # Dopri5Chunked's segment, as in the cfm_fid run


def dopri5_graphs_phase(torch, card_info, dev, out):
    """dopri5's early exit on `compute_fid`'s field (the CIFAR CFM UNet at
    width 128, the live parameters of the cfm_train checkpoint under
    `out`), batch DOPRI5_BATCH: the graphed chain against the eager loop
    (x bitwise and the NFE; wall and device ms, idle shares); then the
    fixed-trip-count scan (graphed) and `Dopri5Chunked` at the calibrated
    budget, x bitwise and the NFE equal to the early exit's."""
    import os

    from tpu_diffusion_torch.cli.main import set_params
    from tpu_diffusion_torch.cli.train_cifar10 import build_model
    from tpu_diffusion_torch.sampling import ode
    from tpu_diffusion_torch.sampling.graph import GraphCache
    from tpu_diffusion_torch.train.checkpoint import CheckpointManager

    torch.manual_seed(0)
    model = build_model(num_channels=128, device=dev)
    own = {k: v.detach() for k, v in model.named_parameters()}
    assets, _ = CheckpointManager(os.path.join(out, "otcfm", "ckpt")).load(
        {"params": own, "ema": own, "step": 0})
    set_params(model, assets["params"])
    model.eval().requires_grad_(False)
    x0 = torch.randn((DOPRI5_BATCH, 32, 32, 3), device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED + 30))
    tol = dict(rtol=DOPRI5_TOL, atol=DOPRI5_TOL)

    def run(graphs=None, **kw):
        def go():
            with torch.no_grad():
                x, nfe = ode.odeint_dopri5(model, x0, graphs=graphs, **tol,
                                           **kw)
            return x, torch.tensor(nfe)
        return go

    want, nfe = run()()
    nfe = int(nfe)
    graphs = GraphCache(model)
    res = graph_vs_eager(
        torch, card_info, "dopri5_cifar", run(), run(graphs), graphs,
        repeats=1, per=nfe, batch=DOPRI5_BATCH, tol=DOPRI5_TOL, nfe=nfe,
        trips=(nfe - 1) // 6,
        note_per="per: the chain's NFE (*_per: ms per UNet evaluation)")
    check(res["bitwise_equal"], f"graphs dopri5: the graphed chain "
                                f"differs from the eager loop: "
                                f"{res['difference']}")
    graphs.clear()

    with torch.no_grad():
        budget = ode.calibrate_dopri5_steps(model, x0, **tol)
    graphs = GraphCache(model)
    variants = {"fixed_trip_graphed": run(graphs, max_steps=budget,
                                          fixed_trip_count=True)}
    chunked = ode.Dopri5Chunked(model, max_steps=budget,
                                chunk_steps=DOPRI5_CHUNK, graphs=graphs, **tol)

    def chunked_run():
        with torch.no_grad():
            x, n = chunked(x0)
        return x, torch.tensor(n)

    variants["chunked"] = chunked_run
    for name, fn in variants.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, n = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        equal = torch.equal(x, want)
        emit(card_info, phase="graphs", chain=f"dopri5_cifar_{name}",
             budget=budget, chunk=DOPRI5_CHUNK if name == "chunked" else None,
             nfe=int(n), early_exit_nfe=nfe, x_bitwise_equal=equal,
             wall_ms=ms, note="wall_ms: one call, its capture included "
                              "where graphed")
        check(equal and int(n) == nfe,
              f"graphs dopri5 {name}: nfe {int(n)} (early exit {nfe}), "
              f"x equal {equal}")
    graphs.clear()
    del model, graphs, chunked
    torch.cuda.empty_cache()


SR_BATCH = 8
SR_STEPS = 20
SR_EVAL_STEPS = 20


# kernel classes of a step's device time, by kernel name (first match)
KERNEL_CLASSES = [
    ("flash", ("flash_",)),
    ("groupnorm", ("Moments", "GroupNorm", "group_norm", "FusedParams",
                   "InternalGradients", "GammaBeta")),
    ("optimizer_ema", ("multi_tensor", "foreach", "adam", "Adam")),
    ("conv_gemm", ("gemm", "conv", "xmma", "cutlass", "cudnn", "fprop",
                   "dgrad", "wgrad", "sm90", "sm80")),
]


def profile_steps(torch, step, steps=3):
    """Device time by kernel class and the top kernels over `steps` calls
    of `step()` under `torch.profiler` (one warm-up call first), in ms per
    call, the device's kernels, memcopies and memsets per call, and the
    host ms per call under the profiler (which adds its own host
    overhead). User annotations on the device timeline (such as
    `Optimizer.step#Adam.step`) span kernels counted on their own, and are
    left out."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    launches = 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
            launches += 1
    classes = {}
    for name, ms in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "elementwise_other")
        classes[cls] = classes.get(cls, 0.0) + ms
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms_per_step": device_ms,
            "launches_per_step": launches / steps,
            "profiled_host_ms_per_step": wall_ms / steps,
            "device_ms_by_class": classes,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def cfm_cond_sr256_phase(torch, card_info, out):
    """`train_cfm_conditional.main --task superres --dataset synthetic256`
    at full width, batch SR_BATCH: 20 steps, then one eval batch by
    Euler-20. Returns the flash kernels' launches."""
    import os

    from tpu_diffusion_torch.cli import train_cfm_conditional as cc
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.models import unet
    args = ["--task", "superres", "--dataset", "synthetic256", "--model",
            "icfm", "--batch_size", str(SR_BATCH), "--num_steps",
            str(SR_STEPS), "--warmup", "5", "--eval_batches", "1",
            "--eval_batch_size", str(SR_BATCH), "--eval_method", "euler",
            "--eval_ode_steps", str(SR_EVAL_STEPS), "--eval_every_div", "0",
            "--output_dir", out]
    with TimedTrainer(cc) as trace:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.flash_fwd_launches = 0
        attention.flash_bwd_launches = 0
        r0 = ran()
        t0 = time.perf_counter()
        res = cc.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_attention_fwd": attention.flash_fwd_launches,
                "flash_attention_bwd": attention.flash_bwd_launches}
    # what ran: the eval's graph replays included, warm-ups and captures not
    executed = delta(ran(), r0)
    first_ms, later = step_times(t0, trace)
    losses = [l for _, l, _, _ in trace]
    per_step = [(f1 - f0, b1 - b0) for (_, _, f0, b0), (_, _, f1, b1)
                in zip([(0, 0, 0, 0)] + trace, trace)]
    train_f, train_b = trace[-1][2], trace[-1][3]
    eval_f = executed.get("flash_attention_fwd", 0) - train_f
    eval_b = executed.get("flash_attention_bwd", 0) - train_b
    results = res["results"]
    state = res["state"]
    # the checkpoint of the final eval, read back
    path = os.path.join(res["output_dir"], "ckpt",
                        f"ckpt_{SR_STEPS:08d}.pt")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    same = saved["step"] == SR_STEPS and all(
        torch.equal(saved[tree][k], v.detach().cpu())
        for tree, params in (("params", state.params),
                             ("ema", state.ema.params))
        for k, v in params.items())
    dtypes = sorted({str(v.dtype) for v in state.params.values()})
    # reckoned activations: every leaf module's output bytes in one forward
    model = state.model
    dev = next(model.parameters()).device
    total = [0]

    def count(_m, _a, out):
        total[0] += out.numel() * out.element_size()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if not list(m.children())]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn((SR_BATCH, 256, 256, 3), generator=gen, device=dev)
    with torch.no_grad():
        model(torch.full((SR_BATCH,), 0.5, device=dev), x, x[:, ::4, ::4])
    for h in hooks:
        h.remove()
    # where a step's device time goes: the CLI's own loss and train step on
    # the trained state, one fixed batch of synthetic256 images
    from tpu_diffusion_torch.losses.cfm import get_matcher
    from tpu_diffusion_torch.train.trainer import make_train_step
    loss_fn = cc.make_loss_fn(
        get_matcher("icfm", sigma=0.0),
        cc.make_condition_fn("superres", (256, 256, 3), 20, -2.0),
        "superres", False, -2.0)
    train_step = make_train_step(loss_fn, ema_decay=0.9999)
    batch = x.clamp(-1, 1)
    breakdown = profile_steps(torch, lambda: train_step(state, batch))
    # the device's busy share of an unprofiled step
    breakdown["device_share_of_median_step"] = (
        breakdown["device_ms_per_step"] / later[len(later) // 2])
    emit(card_info, phase="cfm_cond_sr256", task="superres",
         dataset="synthetic256", batch=SR_BATCH, steps=SR_STEPS,
         seconds=seconds, first_step_ms=first_ms,
         ms_per_step_median=later[len(later) // 2],
         ms_per_step_min=later[0], ms_per_step_max=later[-1],
         peak_memory_gb=peak, n_params=res["n_params"],
         n_params_jax=SR256_PARAMS, param_dtypes=dtypes,
         compute_dtype=str(model.net.dtype),
         activation_bytes_per_forward=total[0],
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         eval=results, eval_method=f"euler-{SR_EVAL_STEPS}",
         flash_fwd_launches_train=train_f, flash_bwd_launches_train=train_b,
         flash_fwd_launches_eval=eval_f, flash_bwd_launches_eval=eval_b,
         checkpoint_equal=same, step_profile=breakdown,
         note="128 channels, (1,1,2,2,4,4), attention at 32/16/8 with 4 "
              "heads (the 32x32 blocks: T=1024, d=64, the flash kernels), "
              "bf16 forward, fp32 parameters and GroupNorm, warmup cut "
              "from 500 to 5; synthetic 256px images; ms per step: host "
              "clock between the per-step metric reads over steps 2-20; "
              "activation_bytes_per_forward: every leaf module's output "
              "in one forward at this batch; step_profile: three more "
              "steps under torch.profiler (device ms per step by kernel "
              "class; the device's share of the median step above); "
              "seconds: the whole "
              "main() call, data and model set-up included; random "
              "weights and 20 steps: no quality claim")
    check(res["n_params"] == SR256_PARAMS,
          f"cfm_cond_sr256: {res['n_params']} parameters, the JAX model "
          f"has {SR256_PARAMS}")
    check(len(losses) == SR_STEPS and all(math.isfinite(l) for l in losses),
          f"cfm_cond_sr256: losses {losses}")
    check(results["num_batches"] == 1 and results["nfe"] == SR_EVAL_STEPS
          and all(math.isfinite(results[k])
                  for k in ("mse", "psnr", "ssim", "nfe")),
          f"cfm_cond_sr256: eval {results}")
    check(all(d == (5, 5) for d in per_step),
          f"cfm_cond_sr256: flash launches per step {per_step}")
    check((eval_f, eval_b) == (5 * SR_EVAL_STEPS, 0),
          f"cfm_cond_sr256: eval flash launches {(eval_f, eval_b)}")
    check(dtypes == ["torch.float32"] and model.net.dtype == torch.bfloat16,
          f"cfm_cond_sr256: parameter types {dtypes}")
    check(same, "cfm_cond_sr256: the checkpoint read back differs")
    del res, state, model, saved
    torch.cuda.empty_cache()
    return launches


PAR_STEPS = 10
RING_SHARDS = 4
# the meshed run's losses after the first against the plain run's: the
# bf16 flash backward's atomic dq sums vary in their last bits from call to
# call, so two plain runs differ too (by 1.5e-5 at most over 10 steps on an
# H100, PERF.md); the first step sees the same weights and must agree
# bitwise
PAR_LOSS_RTOL = 1e-4


def parallel_phase(torch, card_info, dev, out):
    """(a) `train_cfm_conditional.main` at the SR256 width (batch SR_BATCH,
    PAR_STEPS steps, Euler-20 eval) with `--sequence_parallel --model_axis
    1` in a one-rank NCCL world (COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID, `initialize_distributed`), then with no process group in
    the same process, four runs in turns (mesh, plain, plain, mesh), all
    graphed (the meshed step's all-reduce inside its graph): ms per step,
    the idle share, the route line, losses and `sp_decisions` of each, and
    the meshed run's flash launches; in the first meshed turn's world, the
    64px fp32 config at reduced depth over the one-rank mesh, graphed
    against eager, bitwise. (b) The ring's arithmetic on the
    card: `simulated_ring_attention` over RING_SHARDS token shards at
    [32, 1024, 64] bf16 against the flash kernels and the fp32 plain
    version, values and gradients, and its time (a simulated one-card
    figure). Returns the flash launches of (a)'s meshed run."""
    import os

    import torch.distributed as dist
    from tpu_diffusion_torch.cli import train_cfm_conditional as cc
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.parallel import distributed, sp
    from tpu_diffusion_torch.parallel.dryrun import free_port
    args = ["--task", "superres", "--dataset", "synthetic256", "--model",
            "icfm", "--batch_size", str(SR_BATCH), "--num_steps",
            str(PAR_STEPS), "--warmup", "5", "--eval_batches", "1",
            "--eval_batch_size", str(SR_BATCH), "--eval_method", "euler",
            "--eval_ode_steps", str(SR_EVAL_STEPS), "--eval_every_div", "0"]
    env = {"NUM_PROCESSES": "1", "PROCESS_ID": "0"}
    runs = []
    try:
        # in turns: the meshed and the plain run twice each
        for name in ("mesh", "plain", "plain", "mesh"):
            extra = []
            for key in list(env) + ["COORDINATOR_ADDRESS"]:
                os.environ.pop(key, None)  # a plain run joins no group
            if name == "mesh":
                os.environ.update(env, COORDINATOR_ADDRESS=(
                    f"127.0.0.1:{free_port()}"))
                check(distributed.initialize_distributed(device=dev),
                      "parallel: no process group")
                backend, world = dist.get_backend(), dist.get_world_size()
                extra = ["--sequence_parallel", "--model_axis", "1"]
            sp.reset_sp_decisions()
            attention.flash_fwd_launches = 0
            attention.flash_bwd_launches = 0
            r0 = ran()
            with TimedTrainer(cc) as trace:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cc.main(args + extra + [
                    "--output_dir", os.path.join(out, f"{name}{len(runs)}")])
                torch.cuda.synchronize()
            first_ms, later = step_times(t0, trace)
            # the replays' device ms (none on a CPU rehearsal)
            device_ms = sorted(replay_ms(torch, trace)) or [math.nan]
            per_step = [(f1 - f0, b1 - b0) for (_, _, f0, b0), (_, _, f1, b1)
                        in zip([(0, 0, 0, 0)] + trace, trace)]
            runs.append({
                "run": name, "process_group": dist.is_initialized(),
                "losses": [l for _, l, _, _ in trace],
                "first_step_ms": first_ms,
                "ms_per_step_median": later[len(later) // 2],
                "ms_per_step_min": later[0], "ms_per_step_max": later[-1],
                "route": trace.route,
                "replay_device_ms_median": device_ms[len(device_ms) // 2],
                "idle_share": 1 - device_ms[len(device_ms) // 2]
                / later[len(later) // 2],
                "seconds": time.perf_counter() - t0,
                "sp_decisions": sorted({(d["reason"], d["tokens"],
                                         d["axis_size"])
                                        for d in sp.sp_decisions()}),
                "n_sp_decisions": len(sp.sp_decisions()),
                "flash_launches_per_step": per_step,
                "flash_fwd_launches": attention.flash_fwd_launches,
                "flash_bwd_launches": attention.flash_bwd_launches,
                # what ran: the Euler-20 eval's graph replays included
                "flash_fwd_executed": (ran()["flash_attention_fwd"]
                                       - r0["flash_attention_fwd"]),
                "eval": res["results"]})
            del res
            if name == "mesh" and len(runs) == 1:
                # one fp32 meshed step graphed against eager, in this world
                make, _ = tg_cli_main(torch, dev, TG_FP32_OVERRIDES,
                                      meshed=True)
                tg_bitwise(torch, card_info, "mesh_64px_fp32", make,
                           TG_FP32_BATCH, TG_FP32_STEPS, phase="parallel",
                           note="the 64px fp32 config at reduced depth over "
                                "the one-rank NCCL world's mesh (the "
                                "gradients and the loss all-reduced over "
                                "'data' inside the graph): graphed against "
                                "eager")
            if dist.is_initialized():
                dist.destroy_process_group()
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in list(env) + ["COORDINATOR_ADDRESS"]:
            os.environ.pop(key, None)
    mesh, plain = runs[0], runs[1]

    def loss_diffs(a, b):
        return ([x == y for x, y in zip(a["losses"], b["losses"])],
                max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                        b["losses"])))

    bitwise, max_diff = loss_diffs(mesh, plain)
    plain_bitwise, plain_diff = loss_diffs(runs[2], plain)
    ms = {kind: [r["ms_per_step_median"] for r in runs if r["run"] == kind]
          for kind in ("mesh", "plain")}
    emit(card_info, phase="parallel", part="a_one_rank_nccl_world",
         backend=backend, world_size=world, batch=SR_BATCH, steps=PAR_STEPS,
         runs=runs, losses_bitwise_equal_mesh_plain=bitwise,
         max_rel_loss_diff_mesh_plain=max_diff,
         losses_bitwise_equal_plain_plain=plain_bitwise,
         max_rel_loss_diff_plain_plain=plain_diff,
         max_rel_loss_diff_bound=PAR_LOSS_RTOL,
         ms_per_step_median_mesh=ms["mesh"],
         ms_per_step_median_plain=ms["plain"],
         step_ms_ratio_mesh_over_plain=sum(ms["mesh"]) / sum(ms["plain"]),
         idle_share_mesh=[r["idle_share"] for r in runs
                          if r["run"] == "mesh"],
         idle_share_plain=[r["idle_share"] for r in runs
                           if r["run"] == "plain"],
         note="the SR256 CFM CLI (128 channels, (1,1,2,2,4,4), attention "
              "at 32/16/8, bf16 forward, fp32 parameters) from one seed, "
              "four runs in turns (mesh, plain, plain, mesh): mesh: a "
              "one-rank NCCL world, --sequence_parallel --model_axis 1 "
              "(the state broadcast from rank 0, the gradients and the "
              "loss all-reduced over 'data' in one flat buffer inside the "
              "step's CUDA graph, the ring declined: one rank on 'model'); "
              "plain: no process group (the meshed run's variables "
              "removed from the environment); both graphed; ms per step: "
              "host clock between per-step metric reads over steps 2-10; "
              "idle: 1 - the replays' median device ms over it; the "
              "first step of every run sees the same weights and batch, "
              "so its loss must agree bitwise; later steps inherit the "
              "bf16 flash backward's atomic dq sums, whose last bits vary "
              "from call to call (compare plain with plain)")
    check(backend == ("nccl" if dev.type == "cuda" else "gloo")
          and world == 1
          and all(r["process_group"] == (r["run"] == "mesh") for r in runs),
          f"parallel: backend {backend}, world {world}, process groups "
          f"{[(r['run'], r['process_group']) for r in runs]}")
    check(all(len(r["losses"]) == PAR_STEPS
              and all(math.isfinite(l) for l in r["losses"]) for r in runs),
          f"parallel: losses {[r['losses'] for r in runs]}")
    check(bitwise[0] and max_diff <= PAR_LOSS_RTOL,
          f"parallel: meshed losses {mesh['losses']} against plain "
          f"{plain['losses']}")
    check(all(r[0] == "no mesh axis" for run in runs
              for r in run["sp_decisions"])
          and all((run["n_sp_decisions"] > 0) == (run["run"] == "mesh")
                  for run in runs),
          f"parallel: sp decisions {[r['sp_decisions'] for r in runs]}")
    check(all(r["route"].startswith("graphed steps")
              and ("all-reduce over 1 'data'" in r["route"])
              == (r["run"] == "mesh") for r in runs),
          f"parallel: routes {[(r['run'], r['route']) for r in runs]}")
    check(all(d == (5, 5) for d in mesh["flash_launches_per_step"])
          and mesh["flash_fwd_executed"] - 5 * PAR_STEPS
          == 5 * SR_EVAL_STEPS,
          f"parallel: flash launches {mesh['flash_launches_per_step']}, "
          f"{mesh['flash_fwd_executed']} forward in all")
    launches = {"flash_attention_fwd": mesh["flash_fwd_launches"],
                "flash_attention_bwd": mesh["flash_bwd_launches"]}

    # (b) the ring against the flash kernels, in bf16 at the SR256 shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    bh, t, d = 32, 1024, 64
    q, k, v, g = (torch.randn((bh, t, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))

    def grads(fn, dtype):
        xs = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            o = fn(*xs)
            return (o,) + torch.autograd.grad(o, xs, g.to(dtype))

    def ring(a, b, c):
        return sp.simulated_ring_attention(a, b, c, RING_SHARDS)

    def plain32(a, b, c):
        s = torch.einsum("...qd,...kd->...qk", a * d ** -0.5, b)
        return torch.softmax(s, -1) @ c

    got = grads(ring, torch.bfloat16)
    kern = grads(attention.flash_attention, torch.bfloat16)
    want = grads(plain32, torch.float32)
    torch.cuda.synchronize()

    def rel_errs(xs, ys):
        return [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item() for a, b in zip(xs, ys)]

    # tolerance, relative to each tensor's largest entry: the ring returns
    # bf16, and in the backward each shard's k/v gradient is rounded to
    # bf16 once per rotation and summed in bf16 over the shards, as in the
    # JAX ring: at most 2 * shards - 1 roundings of 2^-9; against the
    # kernels, plus their own 1e-2 (the flash_kernel phase's)
    ring_tol = (2 * RING_SHARDS - 1) * 2.0 ** -9
    ring_vs_plain = rel_errs(got, want)
    ring_vs_kernel = rel_errs(got, kern)
    kernel_vs_plain = rel_errs(kern, want)
    with torch.no_grad():
        ring_fwd = time_ms(lambda: ring(q, k, v), iters=5)
        flash_fwd = time_ms(lambda: attention.flash_attention(q, k, v),
                            iters=5)
    ring_fwd_bwd = time_ms(lambda: grads(ring, torch.bfloat16), iters=5)
    flash_fwd_bwd = time_ms(
        lambda: grads(attention.flash_attention, torch.bfloat16), iters=5)
    emit(card_info, phase="parallel", part="b_ring_arithmetic",
         shape=[bh, t, d], dtype="bfloat16", shards=RING_SHARDS,
         rel_err_ring_vs_fp32_plain_o_dq_dk_dv=ring_vs_plain,
         rel_err_ring_vs_flash_kernels_o_dq_dk_dv=ring_vs_kernel,
         rel_err_flash_kernels_vs_fp32_plain_o_dq_dk_dv=kernel_vs_plain,
         rel_tol_ring=ring_tol, rel_tol_ring_vs_kernels=ring_tol + 1e-2,
         ring_fwd_ms_simulated=ring_fwd[0],
         ring_fwd_eager_ms_simulated=ring_fwd[1],
         flash_fwd_ms=flash_fwd[0], flash_fwd_eager_ms=flash_fwd[1],
         ring_fwd_bwd_ms_simulated=ring_fwd_bwd[0],
         ring_fwd_bwd_eager_ms_simulated=ring_fwd_bwd[1],
         flash_fwd_bwd_ms=flash_fwd_bwd[0],
         flash_fwd_bwd_eager_ms=flash_fwd_bwd[1],
         note="simulated_ring_attention: the per-rank arithmetic of "
              f"{RING_SHARDS} ranks run on this one card, the rotation a "
              "shift of a list (no communication): fp32 einsums over "
              "[256, 256] score blocks per head; its times are a simulated "
              "one-card figure, not a multi-card one. Errors: max |x - "
              "ref| over max |ref| for o, dq, dk, dv; the plain version is "
              "fp32 softmax attention on the same bf16-rounded inputs; "
              "ms: device time (CUDA graph), eager_ms: launched from "
              "Python between CUDA events")
    check(all(e <= ring_tol for e in ring_vs_plain),
          f"parallel ring: errors against fp32 {ring_vs_plain}")
    check(all(e <= ring_tol + 1e-2 for e in ring_vs_kernel),
          f"parallel ring: errors against the flash kernels "
          f"{ring_vs_kernel}")
    del got, kern, want
    torch.cuda.empty_cache()
    return launches


DP_RANKS = 4  # the --data-parallel world: one rank per card


def dp_rank():
    """One rank of the `--data-parallel` world (`parallel/dryrun.py:
    run_world` spawns it): the 64px fp32 config at reduced depth over the
    world's (data DP_RANKS x model 1) mesh, eager then graphed, under
    cuDNN's deterministic algorithms. Returns {"eager", "graphed"}: each
    run's record and final state, on the host."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    make, _ = tg_cli_main(torch, dev, TG_FP32_OVERRIDES, meshed=True)
    runs = {}
    for graphed in (False, True):
        rec, final, _ = tg_run(torch, make, graphed, TG_FP32_STEPS, True)
        runs["graphed" if graphed else "eager"] = (
            rec, {k: v.cpu() for k, v in final.items()})
    return runs


def data_parallel_phase(torch, card_info):
    """`--data-parallel`: `dp_rank` on DP_RANKS spawned ranks of one NCCL
    world, one card each. Per rank, the graphed run against the eager one,
    bitwise (loss and gradient-norm traces, parameters, Adam moments, EMA,
    the rank's generator), its route and replays; across ranks, the same
    parameters, EMA and losses (each rank draws its own noise for its
    slice, so the generators differ)."""
    from tpu_diffusion_torch.parallel.dryrun import run_world
    from tpu_diffusion_torch.utils.graphs import WARMUP
    check(torch.cuda.device_count() >= DP_RANKS,
          f"--data-parallel needs {DP_RANKS} cards, has "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    ranks = run_world("chip_smoke:dp_rank", DP_RANKS, "cuda")
    for r, runs in enumerate(ranks):
        (e, fe), (g, fg) = runs["eager"], runs["graphed"]
        equal = tg_equal(fe, fg)
        traces = (e["losses"] == g["losses"]
                  and e["grad_norms"] == g["grad_norms"])
        emit(card_info, phase="data_parallel", rank=r, ranks=DP_RANKS,
             config="mesh_64px_fp32", batch=TG_FP32_BATCH,
             steps=TG_FP32_STEPS, deterministic=True, fit=tg_summary(g, e),
             replays=g.get("replays"), bitwise_equal=equal,
             traces_equal=traces,
             losses={"eager": e["losses"], "graphed": g["losses"]},
             note=f"the 64px fp32 config at reduced depth over a (data "
                  f"{DP_RANKS} x model 1) mesh, {TG_FP32_BATCH // DP_RANKS} "
                  f"images a rank: graphed (the NCCL all-reduce of the "
                  f"gradients and the loss inside the graph) against eager")
        check(g["graphed"] and not e["graphed"] and traces
              and all(equal.values())
              and g["replays"] == [TG_FP32_STEPS - WARMUP],
              f"data_parallel rank {r}: graphed differs from eager: traces "
              f"{traces}, state {equal}, replays {g.get('replays')}, "
              f"routes {g['route']} / {e['route']}")
    first = ranks[0]["graphed"]
    agree = [bool(torch.equal(runs["graphed"][1][k], first[1][k]))
             and runs["graphed"][0]["losses"] == first[0]["losses"]
             for runs in ranks[1:] for k in ("params", "ema")]
    emit(card_info, phase="data_parallel", check="ranks_agree",
         ranks=DP_RANKS, agree=agree, seconds=time.perf_counter() - t0)
    check(all(agree), f"data_parallel: the ranks' parameters, EMA or "
                      f"losses differ: {agree}")


def cfm_cond_64_phase(torch, card_info, out):
    """`train_cfm_conditional.main --task inpaint --weighted_loss` on flowers
    at its defaults (64px, 128 channels, attention at 16x16: T=256, dense,
    no kernel on this path), batch 32, 10 steps, one eval batch of 8 by
    dopri5."""
    from tpu_diffusion_torch.cli import train_cfm_conditional as cc
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.sampling.ode import dopri5_truncated
    steps = 10
    args = ["--task", "inpaint", "--weighted_loss", "--dataset", "flowers",
            "--batch_size", "32", "--num_steps", str(steps),
            "--eval_batches", "1", "--eval_batch_size", "8",
            "--eval_method", "dopri5", "--eval_every_div", "0",
            "--output_dir", out]
    samplers = []
    make_sampler = cc.make_conditional_sampler

    def keep(*a, **kw):
        samplers.append(make_sampler(*a, **kw))
        return samplers[-1]

    cc.make_conditional_sampler = keep
    try:
        with TimedTrainer(cc) as trace:
            torch.cuda.synchronize()
            attention.flash_fwd_launches = 0
            attention.flash_bwd_launches = 0
            t0 = time.perf_counter()
            res = cc.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        cc.make_conditional_sampler = make_sampler
    # the eval's dopri5 went through the graphed early exit
    chains = [c for smp in samplers for c in smp.held["graphs"].chains
              .values()] if samplers and "graphs" in samplers[0].held else []
    replays = {str(sig): n for c in chains for sig, n in c.replays.items()}
    first_ms, later = step_times(t0, trace)
    results = res["results"]
    truncated = dopri5_truncated(int(results["nfe"]), 1000)
    launches = (attention.flash_fwd_launches, attention.flash_bwd_launches)
    emit(card_info, phase="cfm_cond_64", task="inpaint", weighted_loss=True,
         dataset="flowers", batch=32, steps=steps, seconds=seconds,
         first_step_ms=first_ms, ms_per_step_median=later[len(later) // 2],
         ms_per_step_min=later[0], ms_per_step_max=later[-1],
         n_params=res["n_params"], losses=[l for _, l, _, _ in trace],
         eval=results, eval_method="dopri5 (rtol = atol = 1e-5)",
         dopri5_finished=not truncated, flash_launches=list(launches),
         dopri5_graph_replays=replays,
         kernels_on_path="none: attention only at 16x16 (T=256), dense; "
                         "GroupNorm plain",
         note="ms per step: host clock between the per-step metric reads "
              "over steps 2-10; warmup 500 (the default), so 10 steps "
              "barely move the model: no quality claim")
    check(all(math.isfinite(l) for _, l, _, _ in trace)
          and len(trace) == steps, "cfm_cond_64: losses")
    check(results["num_batches"] == 1
          and all(math.isfinite(results[k])
                  for k in ("mse", "psnr", "ssim", "nfe"))
          and results["nfe"] > 6 and not truncated,
          f"cfm_cond_64: eval {results}")
    check(launches == (0, 0), f"cfm_cond_64: flash launches {launches}")
    # one-trip bodies replayed: the trips the NFE needs
    check(replays == {"init": 1, "1": (int(results["nfe"]) - 1) // 6},
          f"cfm_cond_64: the dopri5 eval's graph replays {replays}")
    del res
    torch.cuda.empty_cache()


def cond_mnist_phase(torch, card_info, out):
    """`train_conditional_mnist.main` for cfm, otcfm and sf2m at the default
    32 channels and batch 128: 20 steps each, then the 10x8 class grid
    (Euler-100, or the SDE for sf2m)."""
    from tpu_diffusion_torch.cli import train_conditional_mnist as tcm
    steps = 20
    for variant in ("cfm", "otcfm", "sf2m"):
        with TimedTrainer(tcm) as trace:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = tcm.main(["--variant", variant, "--num_steps", str(steps),
                             "--save_every", "1000", "--output_dir", out])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        first_ms, later = step_times(t0, trace)
        grid = last["grid"]
        n_params = sum(v.numel() for v in last["state"].params.values())
        emit(card_info, phase="cond_mnist", variant=variant, batch=128,
             steps=steps, seconds=seconds, first_step_ms=first_ms,
             ms_per_step_median=later[len(later) // 2],
             ms_per_step_min=later[0], ms_per_step_max=later[-1],
             n_params=n_params, losses=[l for _, l, _, _ in trace],
             grid_shape=list(grid.shape), grid_min=grid.min().item(),
             grid_max=grid.max().item(),
             sampler="sde-100" if variant == "sf2m" else "euler-100",
             class_consistency=last["class_trend"][-1],
             note="32 channels, attention at 14x14 (T=196, dense; no kernel "
                  "on this path), 10 classes; synthetic MNIST, 20 steps at "
                  "warmup 500: no quality claim; ms per step: host clock "
                  "between the per-step metric reads over steps 2-20")
        check(len(trace) == steps
              and all(math.isfinite(l) for _, l, _, _ in trace),
              f"cond_mnist {variant}: losses")
        check(tuple(grid.shape) == (80, 28, 28, 1)
              and bool(torch.isfinite(grid).all())
              and grid.abs().max() <= 1.0,
              f"cond_mnist {variant}: grid {tuple(grid.shape)}")
        del last
    torch.cuda.empty_cache()


def sde_phase(torch, card_info, dev):
    """`sampling/sde.py`'s three samplers on the card over the exact score of
    p0 = N(0.8, 0.05^2) (`core/analytic.py`), recovering p0's mean and
    spread to the JAX test's tolerances
    (tests/test_sde_sweep_conditional.py:35-60)."""
    from tpu_diffusion_torch.core.analytic import marginal_score
    from tpu_diffusion_torch.core.schedules import VPSDE
    from tpu_diffusion_torch.sampling import sde
    vp = VPSDE()
    mu0, s0 = 0.8, 0.05

    def score(x, t):
        return marginal_score(vp, mu0, s0**2, x, t[:, None])

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    runs = [
        ("euler_maruyama", 4096, 500, 0.05, 0.05, lambda xT: sde.euler_maruyama(
            gen, score, vp, xT, 500, return_nan_flag=True)),
        ("probability_flow", 2048, 200, 0.05, None, lambda xT: (
            sde.probability_flow(score, vp, xT, 200), None)),
        ("predictor_corrector", 1024, 200, 0.1, None,
         lambda xT: sde.predictor_corrector(
             gen, score, vp, xT, 200, n_corrector=2,
             return_nan_flag=True)),
    ]
    for name, n, steps, mean_tol, std_tol, run in runs:
        xT = torch.randn((n, 1), generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x0, bad = run(xT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        mean, std = x0.mean().item(), x0.std().item()
        emit(card_info, phase="sde", sampler=name, samples=n, steps=steps,
             seconds=seconds, mean=mean, std=std, want_mean=mu0,
             want_std=s0, mean_tol=mean_tol, std_tol=std_tol,
             nan_flag=None if bad is None else bool(bad),
             device=str(x0.device))
        check(x0.is_cuda and abs(mean - mu0) < mean_tol
              and (std_tol is None or abs(std - s0) < std_tol)
              and (bad is None or not bool(bad)),
              f"sde {name}: mean {mean} std {std} nan {bad}")


# --- the protein stack: train_protein and sample_protein at the reference
# width (train_protein's defaults: 112 residues, (256, 64), 5 conv layers,
# 250 diffusion steps)
PROTEIN = dict(max_len=112, node_scalars=256, node_vectors=64,
               conv_layers=5, diffusion_steps=250)
PROTEIN_PARAMS = 3336001   # jax.eval_shape of the JAX GVPDenoiser()
PROTEIN_TRAIN_BATCH = 32
PROTEIN_TRAIN_STEPS = 10
PROTEIN_RESUME_STEPS = 15  # the second train_protein run resumes at 10
PROTEIN_SAMPLES = 20
PROTEIN_GS = 1500.0
PROTEIN_FORWARD_TOL = 1e-4  # max |card - CPU| over max |eps|, both fp32


def protein_flags(extra):
    return [f for k, v in PROTEIN.items() for f in (f"--{k}", str(v))] + extra


def linear_flops(torch, model, call):
    """2 * rows * in * out summed over the model's Linear layers in one
    `call()`, counted from the shapes they see."""
    total = [0]

    def count(m, inputs, _out):
        total[0] += 2 * inputs[0].numel() * m.out_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Linear)]
    try:
        call()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def quartiles(xs):
    s = sorted(xs)
    n = len(s)
    return {"median": s[n // 2], "q1": s[n // 4], "q3": s[(3 * n) // 4],
            "min": s[0], "max": s[-1], "n": n}


def forward_events(torch, model, events):
    """Record a CUDA event on the current stream whenever `model`'s forward
    starts: one per training or sampling step on these paths, so the
    deltas are the steps' times on the device's timeline (idle gaps
    included). A forward being captured into a CUDA graph records none
    (`ReplayEvents` times the replays)."""
    def pre(_m, _inputs):
        if torch.cuda.is_current_stream_capturing():
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
    return model.register_forward_pre_hook(pre)


class ForwardEvents:
    """Patch `module.build_model` so the models a CLI builds record
    `forward_events`."""

    def __init__(self, torch, module):
        self.torch, self.module, self.real = torch, module, module.build_model
        self.events = []

    def __enter__(self):
        def build(*a, **kw):
            model = self.real(*a, **kw)
            forward_events(self.torch, model, self.events)
            return model
        self.module.build_model = build
        return self.events

    def __exit__(self, *exc):
        self.module.build_model = self.real


class ReplayEvents:
    """Patch `module.GraphCache` so the graphed chains a CLI builds record
    each replay's (start, end) CUDA events into one list."""

    def __init__(self, module):
        self.module, self.real = module, module.GraphCache
        self.events = []

    def __enter__(self):
        events, real = self.events, self.real

        class Timed(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.events = events

        self.module.GraphCache = Timed
        return self.events

    def __exit__(self, *exc):
        self.module.GraphCache = self.real


def event_deltas(torch, events):
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def protein_phase(torch, card_info, dev, out):
    """The protein stack at the reference width: the parameter count, one
    forward on the card against the CPU, `cli.train_protein.main` (a run,
    then a resumed run; `Trainer.fit_scanned` is phase train_graphs'),
    then `cli.sample_protein.main` guided (gs 1500, cond_start_step 125 of
    250) and unguided."""
    import os

    from tpu_diffusion_torch.cli import sample_protein, train_protein
    from tpu_diffusion_torch.data.device_cache import make_protein_sampler
    from tpu_diffusion_torch.protein.data import get_protein_data
    from tpu_diffusion_torch.protein.sde import (HoogeboomGraphSDE,
                                                 ProteinBatch)
    from tpu_diffusion_torch.train.trainer import make_train_step
    args = train_protein.parser().parse_args(protein_flags([]))
    n_len, b = args.max_len, PROTEIN_SAMPLES

    # --- the parameter count and one forward, card against CPU ----------
    torch.manual_seed(SEED)
    cpu_model = train_protein.build_model(args, "cpu").eval()
    model = train_protein.build_model(args, dev).eval()
    model.load_state_dict(cpu_model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    ds = get_protein_data("data/scope", max_len=n_len, seed=SEED)
    pos = torch.from_numpy(ds.positions[:b])
    mask = torch.arange(n_len)[None] < torch.from_numpy(ds.lengths[:b])[:, None]
    t = torch.linspace(0.05, 0.95, b)
    with torch.no_grad():
        want = cpu_model(ProteinBatch.from_positions(pos, mask), t)
    batch = ProteinBatch.from_positions(pos.to(dev), mask.to(dev))
    td = t.to(dev)

    def forward():
        with torch.no_grad():
            return model(batch, td)

    flops = linear_flops(torch, model, forward)
    got = forward().cpu()
    diff = (got - want).abs()
    fwd_ms, fwd_eager_ms = time_ms(forward, iters=3)
    torch.cuda.reset_peak_memory_stats()
    forward()
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    fwd_bound = flops / FP32_FLOPS * 1e3
    pairs = b * n_len * n_len
    emit(card_info, phase="protein_forward", batch=b, residues=n_len,
         width=[args.node_scalars, args.node_vectors],
         conv_layers=args.conv_layers, n_params=n_params,
         n_params_jax=PROTEIN_PARAMS, max_abs_diff=diff.max().item(),
         mean_abs_diff=diff.mean().item(),
         max_abs_eps=want.abs().max().item(),
         mean_abs_eps=want.abs().mean().item(),
         tol=f"max |card - CPU| <= {PROTEIN_FORWARD_TOL} * max |eps|: fp32 "
             "on both, TF32 off; only the order of the sums differs",
         linear_flops=flops, flops_per_pair=flops / pairs,
         bound_ms=fwd_bound, bound_by="operations (fp32, 67 TFLOP/s)",
         device_ms=fwd_ms, eager_ms=fwd_eager_ms,
         fp32_tflops=flops / fwd_ms / 1e9, peak_memory_gb=fwd_peak,
         note="random weights from seed 0 (the CLI's initialisation); "
              "synthetic chains at t in [0.05, 0.95]; flops: the Linear "
              "layers' products (the dense [B, N, N] messages), counted "
              "from their shapes; device_ms: CUDA-graph replay")
    check(n_params == PROTEIN_PARAMS,
          f"protein: {n_params} parameters, the JAX model has "
          f"{PROTEIN_PARAMS}")
    check(bool(torch.isfinite(got).all())
          and diff.max() <= PROTEIN_FORWARD_TOL * want.abs().max(),
          f"protein: the card's forward differs from the CPU's by "
          f"{diff.max().item()}")
    del cpu_model, want

    # --- train_protein.main, then a resumed run -------------------------
    train_out = os.path.join(out, "protein")
    common = protein_flags(["--output_dir", train_out, "--batch_size",
                            str(PROTEIN_TRAIN_BATCH), "--ckpt_every", "5",
                            "--seed", str(SEED)])
    runs = {}
    for name, steps in (("fit", PROTEIN_TRAIN_STEPS),
                        ("fit_resumed", PROTEIN_RESUME_STEPS)):
        with TimedTrainer(train_protein) as trace:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_protein.main(common + ["--num_steps", str(steps)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        _, wall = step_times(t0, trace)
        runs[name] = {
            "steps": len(trace), "final_step": res["state"].step,
            "seconds": seconds,
            "wall_ms_per_step": quartiles(wall),
            "replay_device_ms": quartiles(replay_ms(torch, trace)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": [l for _, l, _, _ in trace]}
    ckpts = sorted(os.listdir(os.path.join(train_out, "gvp", "ckpt")))
    fit_state = res["state"]
    # where a training step's device time goes: the CLI's loss and step on
    # the trained state, one fixed batch
    diffuser = HoogeboomGraphSDE(num_steps=args.diffusion_steps, device=dev)
    loss_fn = train_protein.make_loss_fn(diffuser, args.aux_weight,
                                         args.aux_cutoff, args.distogram)
    sampler = make_protein_sampler(ds.positions, ds.lengths,
                                   PROTEIN_TRAIN_BATCH, device=dev)
    fixed = sampler(torch.Generator(device=dev).manual_seed(SEED))
    train_step = make_train_step(loss_fn, ema_decay=0.999)
    train_profile = profile_steps(torch, lambda: train_step(fit_state, fixed))
    del fit_state, res

    step_bound = 3 * flops * PROTEIN_TRAIN_BATCH / b / FP32_FLOPS * 1e3
    emit(card_info, phase="protein_train", batch=PROTEIN_TRAIN_BATCH,
         residues=n_len, width=[args.node_scalars, args.node_vectors],
         conv_layers=args.conv_layers, runs=runs, checkpoints=ckpts,
         step_bound_ms=step_bound, step_profile=train_profile,
         note="runs: train_protein.main for 10 steps, then again to 15 "
              "(resuming from the step-10 checkpoint, EMA included), "
              "graphed (fit_scanned and the eager twin: phase "
              "train_graphs); wall: host clock between per-step metric "
              "reads; replay_device_ms: each graph replay's CUDA events; "
              "step_bound_ms: three forwards' products (forward, and the "
              "backward's two) at fp32's 67 TFLOP/s; step_profile: "
              "device ms by kernel class of three eager steps on a fixed "
              "batch under torch.profiler")
    check(all(math.isfinite(l) for r in runs.values() for l in r["losses"])
          and runs["fit"]["steps"] == PROTEIN_TRAIN_STEPS
          and runs["fit_resumed"]["steps"]
          == PROTEIN_RESUME_STEPS - PROTEIN_TRAIN_STEPS
          and runs["fit_resumed"]["final_step"] == PROTEIN_RESUME_STEPS,
          f"protein_train: runs {runs}")
    check("ckpt_00000015.pt" in ckpts, f"protein_train: checkpoints {ckpts}")

    # --- sample_protein.main: guided, then unguided ---------------------
    ckpt_dir = os.path.join(train_out, "gvp", "ckpt")
    sample_common = protein_flags([
        "--ckpt_dir", ckpt_dir, "--num_samples", str(b), "--batch_size",
        str(b), "--seed", str(SEED), "--guidance_scale", str(PROTEIN_GS)])
    sampled = {}
    for name, extra in (("guided", []), ("unguided", ["--no_conditioner"])):
        with ForwardEvents(torch, sample_protein) as events, \
                ReplayEvents(sample_protein) as replays:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sample_protein.main(sample_common + extra + [
                "--output_dir", os.path.join(out, f"protein_{name}")])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        # the unguided chain is graphed: one replay a step, timed alone
        deltas = (event_deltas(torch, events) if name == "guided" else
                  [a.elapsed_time(b) for a, b in replays])
        # event k starts step 249 - k; delta k is that step's time (the
        # forward events miss the last step's end; the replays have it)
        chain_ms = sum(deltas) + (deltas[-1] if name == "guided" else 0.0)
        cond_start = args.diffusion_steps // 2
        n_plain = args.diffusion_steps - cond_start
        pos_s, mask_s = res["pos"], res["mask"]
        m = mask_s[..., None].float()
        com = (pos_s * m).sum(1) / m.sum(1)
        rg = (((pos_s - com[:, None]) ** 2).sum(-1) * mask_s).sum(1) \
            / mask_s.sum(1)
        sampled[name] = {
            "seconds_main": seconds,
            "chain_seconds": chain_ms / 1e3,
            "seconds_per_sample": chain_ms / 1e3 / b,
            "unguided_ms_per_step": quartiles(deltas[:n_plain]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "forwards": len(events), "replays": len(replays),
            "summary": res["summary"],
            "finite": bool(torch.isfinite(pos_s).all()),
            "max_abs_pos": pos_s.abs().max().item(),
            "max_abs_com": com.abs().max().item(),
            "max_com_over_rg": (com.norm(dim=-1) / rg.sqrt()).max().item()}
        if name == "guided":
            sampled[name]["guided_ms_per_step"] = quartiles(
                deltas[n_plain:])
    # one guided and one plain step under the profiler, on the trained EMA
    # weights
    model = sample_protein.build_model(args, dev).eval()
    saved = torch.load(os.path.join(ckpt_dir, "ckpt_00000015.pt"),
                       map_location="cpu", weights_only=True)
    model.load_state_dict(saved["ema"])
    model.requires_grad_(False)
    motif_pos, motif_idx = sample_protein.load_motif(None, None, n_len, SEED,
                                                     dev)
    from tpu_diffusion_torch.protein.conditioner import Structconditioner
    cond = Structconditioner(motif_pos=motif_pos, motif_indices=motif_idx,
                             guidance_scale=PROTEIN_GS)
    guided_profile = profile_steps(
        torch, lambda: cond.guide(batch, model, 10, diffuser))
    plain_profile = profile_steps(torch, forward)
    emit(card_info, phase="protein_sample", samples=b, residues=n_len,
         diffusion_steps=args.diffusion_steps, cond_start_step=cond_start,
         guidance_scale=PROTEIN_GS, runs=sampled,
         guided_step_profile=guided_profile,
         plain_step_profile=plain_profile, forward_bound_ms=fwd_bound,
         note="sample_protein.main from the step-15 checkpoint's EMA "
              "weights, 20 chains of 112 residues, 250 steps (no cut); "
              "guided: the conditioner at gs 1500 for steps < 125, whose "
              "forward with a graph to the positions also gives the "
              "step's eps_hat; ms per step: CUDA events at each step's "
              "forward (device timeline, idle gaps included), and for "
              "the unguided chain, a graphed chain, each replay's "
              "events (device time of the step alone); "
              "chain_seconds: their sum plus the last step; the "
              "profiles: the guidance at step 10 and a plain forward; the "
              "guided samples' COM drifts as the JAX package's "
              "does (the guidance update is not projected); random-init "
              "weights after 15 steps: no quality claim")
    g, u = sampled["guided"], sampled["unguided"]
    check(g["finite"] and u["finite"]
          and g["forwards"] == u["replays"] == args.diffusion_steps
          and g["replays"] == 0,
          f"protein_sample: finite {g['finite']} {u['finite']}, forwards "
          f"{g['forwards']}, replays {g['replays']} {u['replays']}")
    check(math.isfinite(g["summary"]["cond_loss_mean"])
          and g["summary"]["num_samples"] == b
          and g["summary"]["ckpt_step"] == PROTEIN_RESUME_STEPS,
          f"protein_sample: summary {g['summary']}")
    check(u["max_abs_com"] <= 1e-4 * max(1.0, u["max_abs_pos"]),
          f"protein_sample: unguided samples' COM {u['max_abs_com']}")
    del model, batch
    torch.cuda.empty_cache()


# the CA-ProteinMPNN at its published width (hidden 128, k 48, 3 encoder and
# 3 decoder layers), random weights from seed 0
MPNN_PARAMS = 1627717      # jax.eval_shape of the JAX CAProteinMPNN()
MPNN_LP_TOL = 1e-4         # max |card - CPU| of teacher-forced log-probs
MPNN_N_SEQ = 3
MPNN_DESIGNS_TIMED = 3     # designs timed alone (wall, and under the profiler)
EVAL_MAX_TRAIN = 200
NOVELTY_CHECK = (2, 20)    # samples x training chains, C++ scan against numpy
MOTIF_RES = "WHYKDEPC"


def spawn_seconds(args):
    """Wall seconds of a fresh interpreter running `args` (`-c ...`)."""
    import os
    t0 = time.perf_counter()
    subprocess.run([sys.executable, *args], check=True, timeout=300,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    return time.perf_counter() - t0


def protein_eval_phase(torch, card_info, dev, sample_dir, work):
    """Protein sample evaluation on the samples of `sample_dir` (the guided
    ones of `protein_phase`): the CA-ProteinMPNN at its published width on
    the card against the CPU, `self_consistency_eval` with it, the
    evaluation CLI's `main` with the novelty scan and the training-set
    comparison (its training set and cache under `work`), the C++ scan
    against its numpy version, and the timings."""
    import contextlib
    import io
    import os

    import numpy as np

    from tpu_diffusion_torch.cli.sample_protein import load_motif
    from tpu_diffusion_torch.protein import evaluate, mpnn, novelty
    from tpu_diffusion_torch.protein.data import get_protein_data
    from tpu_diffusion_torch.protein.self_consistency import (
        proteinmpnn_scores, self_consistency_eval)
    from tpu_diffusion_torch.protein.sync_probe import count_syncs
    from tpu_diffusion_torch.utils.debug import compiled_cost

    structures = evaluate.load_structures(sample_dir)
    check(len(structures) == PROTEIN_SAMPLES,
          f"protein_eval: {len(structures)} samples in {sample_dir}")
    lengths = [len(v) for v in structures.values()]

    # --- the MPNN at the published width, card against CPU --------------
    scorer = mpnn.load_mpnn_scorer(seed=SEED, device=dev)
    model = scorer.model
    n_params = sum(p.numel() for p in model.parameters())
    cpu_model = mpnn.CAProteinMPNN(hidden=model.hidden, k=model.k,
                                   device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    coords = next(iter(structures.values())).astype(np.float32)
    n = len(coords)
    order = scorer._order(n, SEED)
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, 21, (n,), generator=gen)
    noise = mpnn.gumbel_noise((n, 21), gen, "cpu")
    x_c = torch.from_numpy(coords)
    x_d, tok_d = x_c.to(dev), tokens.to(dev)
    order_c = torch.from_numpy(order)
    order_d = order_c.to(dev)
    ones_c, ones_d = torch.ones(n), torch.ones(n, device=dev)
    zeros = torch.zeros(n)
    with torch.no_grad():
        lp_c = cpu_model(x_c, tokens, order_c)
        lp_d = model(x_d, tok_d, order_d)
    lp_diff = (lp_d.cpu() - lp_c).abs().max().item()
    e_c, _ = mpnn.knn_graph(x_c, ones_c, model.k)
    e_d, _ = mpnn.knn_graph(x_d, ones_d, model.k)
    e_d = e_d.cpu()
    sets_equal = torch.equal(e_c.sort(-1).values, e_d.sort(-1).values)
    order_equal = torch.equal(e_c, e_d)
    _, sample_c = mpnn.make_mpnn_fns(cpu_model)
    _, sample_d = mpnn.make_mpnn_fns(model)
    design_c = sample_c(x_c, order, ones_c, zeros.long(), zeros,
                        scorer.temperature, noise=noise)
    design_d = sample_d(x_d, order, ones_d, zeros.long(), zeros,
                        scorer.temperature, noise=noise).cpu()
    first_diff = None
    if not torch.equal(design_c, design_d):
        # the first step whose token differs, and the CPU's logit margin
        # there (best minus runner-up of lp / T + g), on the CPU's chain
        step = next(i for i, p in enumerate(order)
                    if design_c[p] != design_d[p])
        p = int(order[step])
        with torch.no_grad():
            prefix = design_c.clone()
            lp = cpu_model(x_c, prefix, order_c)[p]
        top = torch.topk(lp / scorer.temperature + noise[step], 2).values
        first_diff = {"step": step, "position": p,
                      "cpu_token": int(design_c[p]),
                      "card_token": int(design_d[p]),
                      "cpu_margin": (top[0] - top[1]).item()}
    syncs = count_syncs(torch, lambda: scorer.sample(coords, seed=SEED))

    # --- timings: one pass, one decode step, one design ------------------
    flops_pass = compiled_cost(lambda: model(x_d, tok_d, order_d))["flops"]
    with torch.no_grad():
        enc = model.encode(x_d, ones_d)
        flops_step = compiled_cost(lambda: model.decode(
            *enc[:3], ones_d, enc[3], tok_d, order_d))["flops"]

        def one_pass():
            return model(x_d, tok_d, order_d)

        def one_step():
            return model.decode(*enc[:3], ones_d, enc[3], tok_d, order_d)

        pass_ms, pass_eager_ms = time_ms(one_pass, iters=10)
        step_ms, step_eager_ms = time_ms(one_step, iters=10)
        step_profile = profile_steps(torch, one_step)
    design_wall = []
    for seed in range(MPNN_DESIGNS_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.sample(coords, seed=seed)
        design_wall.append(time.perf_counter() - t0)
    design_profile = profile_steps(
        torch, lambda: scorer.sample(coords, seed=SEED), steps=1)
    design_busy_ms = design_profile["device_ms_per_step"]
    design_launches = design_profile["launches_per_step"]
    design_s = sorted(design_wall)[len(design_wall) // 2]
    emit(card_info, phase="protein_eval_mpnn", residues=n,
         hidden=model.hidden, k=model.k, n_params=n_params,
         n_params_jax=MPNN_PARAMS, lp_max_abs_diff=lp_diff,
         lp_tol=f"max |card - CPU| <= {MPNN_LP_TOL}: fp32 on both, TF32 "
                "off; only the order of the sums differs",
         knn_sets_equal=sets_equal, knn_order_equal=order_equal,
         design_equal=first_diff is None, first_difference=first_diff,
         syncs_per_design=syncs,
         pass_flops=flops_pass, pass_bound_ms=flops_pass / FP32_FLOPS * 1e3,
         bound_by="operations (fp32, 67 TFLOP/s)",
         pass_device_ms=pass_ms, pass_eager_ms=pass_eager_ms,
         step_flops=flops_step,
         step_bound_ms=flops_step / FP32_FLOPS * 1e3,
         step_device_ms=step_ms, step_wall_ms=step_eager_ms,
         step_launches=step_profile["launches_per_step"],
         step_profile=step_profile,
         design_seconds=design_wall, design_seconds_median=design_s,
         design_launches=design_launches, design_busy_ms=design_busy_ms,
         design_idle_share=1 - design_busy_ms / 1e3 / design_s,
         note="random weights from seed 0 (not the published model); the "
              "first guided sample; pass: one teacher-forced forward "
              "(encoder and one decode pass), step: one decode pass of "
              "the design loop; flops: the GEMMs by FlopCounterMode; "
              "device_ms: CUDA-graph replay, eager/wall ms: launched from "
              "Python; design: scorer.sample (encoder, then one decode "
              "pass per residue, Gumbel draws on the card), its seconds "
              "alone, its launches and busy ms under torch.profiler, idle "
              "share = 1 - busy / the median seconds alone; step_profile: "
              "a decode step's device ms by kernel class under "
              "torch.profiler; syncs: sync "
              "debug mode over one design (the host copies in and out)")
    check(n_params == MPNN_PARAMS,
          f"protein_eval: the MPNN has {n_params} parameters, the JAX one "
          f"{MPNN_PARAMS}")
    check(lp_diff <= MPNN_LP_TOL and bool(torch.isfinite(lp_d).all()),
          f"protein_eval: log-probs differ by {lp_diff}")
    check(sets_equal, "protein_eval: the card's k-NN sets differ from the "
                      "CPU's")
    check(first_diff is None,
          f"protein_eval: the card's design differs from the CPU's: "
          f"{first_diff}")
    check(syncs < n // 4, f"protein_eval: {syncs} host syncs in one design "
                          f"of {n} steps")
    del cpu_model

    # --- self_consistency_eval over the samples ---------------------------
    sc_dir = os.path.join(work, "self_consistency")
    os.makedirs(sc_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = self_consistency_eval(structures, sc_dir, scorer=scorer,
                                 n_seq=MPNN_N_SEQ)
    sc_seconds = time.perf_counter() - t0
    scores = [s for r in rows for s in r.get("protein_mpnn_scores", [])]
    seq_lens = [{len(q) for q in r.get("protein_mpnn_seqs", [])}
                for r in rows]
    _, motif_idx = load_motif(None, None, PROTEIN["max_len"], SEED)
    motif_idx = motif_idx.tolist()
    motif_res = MOTIF_RES[:len(motif_idx)]
    host = next(v for v in structures.values() if len(v) > max(motif_idx))
    m_scores, m_seqs = proteinmpnn_scores(host, scorer, n_seq=MPNN_N_SEQ,
                                          motif_inds=motif_idx,
                                          motif_res=motif_res)
    motif_kept = all("".join(q[i] for i in motif_idx) == motif_res
                     for q in m_seqs)
    emit(card_info, phase="protein_eval_self_consistency",
         samples=len(rows), n_seq=MPNN_N_SEQ, seconds=sc_seconds,
         seconds_per_sample=sc_seconds / len(rows),
         score_min=min(scores), score_max=max(scores),
         score_mean=sum(scores) / len(scores),
         motif_indices=motif_idx, motif_res=motif_res,
         motif_kept=motif_kept, motif_scores=m_scores.tolist(),
         note="self_consistency_eval with the published-width MPNN "
              "(random weights): per sample one design, then n_seq "
              "teacher-forced re-scorings; ColabFold is absent, so the "
              "refolding stage skips; then proteinmpnn_scores on one "
              "sample with the sampling motif's indices fixed")
    check(len(rows) == PROTEIN_SAMPLES
          and len(scores) == PROTEIN_SAMPLES * MPNN_N_SEQ
          and all(0 < s <= 1 for s in scores),
          f"protein_eval: self-consistency scores {scores}")
    check(seq_lens == [{ln} for ln in lengths],
          f"protein_eval: sequence lengths {seq_lens} against {lengths}")
    check(os.path.exists(os.path.join(sc_dir, "protein_mpnn_seqs.csv")),
          "protein_eval: protein_mpnn_seqs.csv not written")
    check(motif_kept, f"protein_eval: motif residues not kept: {m_seqs}")

    # --- the evaluation CLI ---------------------------------------------
    train_root = os.path.join(work, "scope")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # it prints the summary
        evaluate.main(["--sample_dir", sample_dir, "--train_root",
                       train_root, "--novelty", "--compare_train",
                       "--max_train", str(EVAL_MAX_TRAIN)])
    main_seconds = time.perf_counter() - t0
    with open(os.path.join(sample_dir, "summary_stats.json")) as f:
        summary = json.load(f)
    stat_rows = evaluate._read_csv(os.path.join(sample_dir,
                                                "sample_stats.csv"))
    ds = get_protein_data(train_root)
    train = {f"train_{i}": ds.positions[i][:ds.lengths[i]] / (1.0 / 15.0)
             for i in range(min(len(ds), EVAL_MAX_TRAIN))}
    t0 = time.perf_counter()
    found = [novelty.find_closest_structure(c, train)
             for c in structures.values()]
    scan_seconds = time.perf_counter() - t0
    windows = sum(max(1, abs(len(c) - len(v))) for c in structures.values()
                  for v in train.values())
    n_s, n_t = NOVELTY_CHECK
    keys = list(train)[:n_t]
    scan_diff = 0.0
    for c in list(structures.values())[:n_s]:
        got = novelty.find_closest_structure(c, {k: train[k] for k in keys})
        want = novelty._np_find_closest(
            novelty._prep(c), keys, [novelty._prep(train[k]) for k in keys])
        scan_diff = max([scan_diff] + [abs(got[k] - want[k]) for k in
                                       ("rmsd", "tm_score", "gdt_score")])
        check(all(got[k] == want[k] for k in got if k.endswith("_match")),
              f"protein_eval: the C++ scan's matches {got} against {want}")
    pipeline = evaluate.EvaluationPipeline(
        list(evaluate.DEFAULT_STAGES) + [evaluate.make_novelty_stage(train)])
    many = {}
    for n_jobs in (1, -1):
        t0 = time.perf_counter()
        out_rows = pipeline.eval_many(structures, n_jobs=n_jobs)
        many[str(n_jobs)] = time.perf_counter() - t0
        check(len(out_rows) == PROTEIN_SAMPLES
              and not any(k.endswith("_error") for r in out_rows for k in r),
              f"protein_eval: eval_many(n_jobs={n_jobs}) rows {out_rows}")
    worker = {"bare": spawn_seconds(["-c", "pass"]),
              "import_evaluate": spawn_seconds(
                  ["-c", "import tpu_diffusion_torch.protein.evaluate"])}
    jax_keys = [f"{k}_{s}" for k in stat_rows[0]
                if isinstance(stat_rows[0][k], float)
                for s in ("mean", "std", "median")]
    w1 = {k: v for k, v in summary.items() if k.endswith("_w1_vs_train")}
    tm = [r["novelty_tm_score"] for r in stat_rows]
    gdt = [r["novelty_gdt_score"] for r in stat_rows]
    emit(card_info, phase="protein_eval_cli", samples=len(stat_rows),
         lengths=lengths, max_train=EVAL_MAX_TRAIN,
         main_seconds=main_seconds, novelty_scan_seconds=scan_seconds,
         novelty_windows=windows,
         novelty_tm_mean=sum(tm) / len(tm), novelty_gdt_mean=sum(gdt)
         / len(gdt), novelty_rmsd_mean=sum(r["novelty_rmsd"]
                                           for r in stat_rows) / len(tm),
         scan_vs_numpy_max_abs_diff=scan_diff,
         scan_check=f"{n_s} samples x {n_t} training chains",
         eval_many_seconds=many, cpu_count=os.cpu_count(),
         worker_start_seconds=worker, summary_keys=len(summary),
         w1_fields=len(w1),
         note="main: `python -m tpu_diffusion_torch.protein.evaluate "
              "--novelty --compare_train --max_train 200` by its main(argv) "
              "(the synthetic training chains: the repository holds no "
              "SCOPe data); novelty scan: find_closest_structure of every "
              "sample against the 200 chains, host C++; eval_many: the "
              "default stages and the novelty stage, n_jobs 1 and -1 "
              "(spawned process pool); worker_start: a fresh interpreter, "
              "bare and importing the evaluation module (torch included)")
    check(len(stat_rows) == PROTEIN_SAMPLES,
          f"protein_eval: sample_stats.csv has {len(stat_rows)} rows")
    check(all(k in summary for k in jax_keys) and w1,
          f"protein_eval: summary_stats.json keys {sorted(summary)}")
    check(all(0 <= v <= 1 for v in tm + gdt),
          f"protein_eval: novelty TM {tm}, GDT {gdt}")
    check(all(math.isfinite(v) for v in w1.values()),
          f"protein_eval: Wasserstein fields {w1}")
    check(scan_diff <= 1e-9,
          f"protein_eval: the C++ scan differs from numpy by {scan_diff}")
    check(all(0 <= f["tm_score"] <= 1 for f in found),
          "protein_eval: novelty scan out of range")
    del model, scorer
    torch.cuda.empty_cache()


# --- the graphed chains (sampling/graph.py): graph replay against the eager
# chain on each fixed-length sampler of the port
GRAPH_REPEATS = 5         # timed graphed chains per configuration
GRAPH_COND_STEPS = 100    # the cached amortized 64px chain, cut from 1000
GRAPH_SR_STEPS = 20       # the SR256 eval's Euler-20 (no cut)
GRAPH_PROTEIN_STEPS = 50  # the unguided protein chain, cut from 250
GRAPH_MPNN_LEN = 105      # residues of the designed chain (protein_eval's)
# the reconstruction-guidance chain, cut from 1000 steps: (network.dtype,
# conditioning.start_fraction, steps, timed graphed chains); at 0.5 the
# plain and the guided bodies, at 1.0 (the config's) only the guided ones;
# fp32 (five times bf16's time a step) cut furthest, to the 21 steps the
# VP-SDE's schedule needs at least (`core/schedules.py:DDPM.create`)
GUIDED_RUNS = (("bfloat16", 0.5, 50, 2), ("bfloat16", 1.0, 50, 2),
               ("float32", 0.5, 22, 1))


def ran():
    """{kernel: launches that ran on the card}: the wrappers' counts less
    the graphs' warm-ups and captures, plus the graph replays'."""
    from tpu_diffusion_torch.kernels import executed_launches
    return executed_launches()


def delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def graph_vs_eager(torch, card_info, name, eager, graphed, graphs,
                   repeats=GRAPH_REPEATS, per=None, spread=False, **fields):
    """One eager chain (after an untimed one) and the graphed chain (its
    first call captures), then
    `repeats` timed graphed chains: the outputs bitwise equal (or, trap (d)
    in ROADMAP, within the full forward's tolerance), the replays' kernel
    launches equal to the eager chain's; wall ms of each, the graphed
    chains' device ms (the sum of their replays' CUDA-event times) and
    idle share, capture seconds and pool bytes. `per` divides the times
    (steps of the chain). `graphs` is the chains' GraphCache, or a
    function giving it after the first graphed call (a sampler that makes
    its own). With `spread`, the untimed eager chain's output is held
    against the timed one's too (a chain whose kernels sum with atomics
    differs from itself), and an output that is not bitwise must differ
    from the eager chain's by at most twice as much in mean |difference|,
    in place of trap (d)'s tolerance. Returns the emitted fields."""
    def tensors(out):
        return out if isinstance(out, tuple) else (out,)

    # warm-up, not timed: first uses of kernels and libraries
    first = eager()
    torch.cuda.synchronize()
    r0, t0 = ran(), time.perf_counter()
    want = eager()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    r1 = ran()
    before = set() if callable(graphs) else set(graphs.chains)
    t0 = time.perf_counter()
    got = graphed()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    r2 = ran()
    if callable(graphs):
        graphs = graphs()
    chains = [graphs.chains[s] for s in set(graphs.chains) - before]
    eager_launches, graph_launches = delta(r1, r0), delta(r2, r1)
    wall, device = [], []
    for _ in range(repeats):
        graphs.events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = graphed()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        device.append(graphs.device_ms())
    graphs.events = None
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(tensors(got), tensors(want))) and all(
        torch.equal(a, b) for a, b in zip(tensors(again), tensors(got)))
    tol_ok, diff, eager_spread = True, None, None
    if spread:
        d = (tensors(first)[0].float() - tensors(want)[0].float()).abs()
        eager_spread = {"max_abs_diff": d.max().item(),
                        "mean_abs_diff": d.mean().item()}
    if not bitwise:
        g, w = tensors(got)[0].float(), tensors(want)[0].float()
        d = (g - w).abs()
        diff = {"max_abs_diff": d.max().item(),
                "mean_abs_diff": d.mean().item(),
                "max_abs_ref": w.abs().max().item(),
                "mean_abs_ref": w.abs().mean().item()}
        if spread:
            # the mean alone: where the chain diverges from its own last
            # bits, both maxima saturate at the range (2 in [-1, 1])
            tol_ok = (d.mean().item()
                      <= 2 * eager_spread["mean_abs_diff"])
        else:
            tol_ok = (d.max() <= 0.1 * w.abs().max()
                      and d.mean() <= 0.03 * w.abs().mean())
    k = per or 1
    dev_q = quartiles(device)
    out = dict(
        phase="graphs", chain=name, **fields, bitwise_equal=bitwise,
        difference=diff, eager_vs_eager=eager_spread, eager_seconds=eager_s,
        first_graphed_seconds=first_s,
        capture_s=sum(sum(c.capture_s.values()) for c in chains),
        pool_bytes=sum(sum(c.pool_bytes.values()) for c in chains),
        bodies={str(len(sig)) if isinstance(sig, tuple) and not any(sig)
                else str(sig):
                {"launches_per_replay": c.launches.get(sig, {}),
                 "replays": c.replays[sig],
                 "capture_s": c.capture_s.get(sig, 0.0),
                 "pool_bytes": c.pool_bytes.get(sig, 0)}
                for c in chains for sig in c.bodies},
        eager_launches=eager_launches, graph_launches=graph_launches,
        wall_ms=quartiles(wall), device_ms=dev_q,
        idle_share=quartiles([1 - d / w for d, w in zip(device, wall)]),
        eager_idle_share=1 - dev_q["median"] / (eager_s * 1e3),
        per=per, wall_ms_per=quartiles([w / k for w in wall]),
        device_ms_per=quartiles([d / k for d in device]),
        eager_ms_per=eager_s * 1e3 / k,
        note="eager: one chain launched from Python; graphed: its body "
             "captured once (first_graphed_seconds includes the warm-up and "
             "capture), then replayed; device_ms: the sum of the replays' "
             "CUDA-event times; idle_share: 1 - device / wall; "
             "eager_idle_share: 1 - the graphed device median / the eager "
             "wall time (the same work)")
    emit(card_info, **out)
    check(bitwise or tol_ok, f"graphs {name}: the graphed chain differs "
                             f"from the eager one: {diff}")
    check(graph_launches == eager_launches,
          f"graphs {name}: replays launched {graph_launches}, the eager "
          f"chain {eager_launches}")
    return out


def guidance_graphs(torch, card_info, dev):
    """The reconstruction-guidance 64px chain of `cli.make_samplers` at the
    `flowers,inpainting,reconstruction_guidance` config (full width, batch
    COND_BATCH, gamma 10, cut in depth) for each of GUIDED_RUNS,
    graphed against eager: the guided body differentiates inside its
    capture, so the flash backward is replayed from a graph. fp32, with
    cuDNN's deterministic algorithms, is held bitwise: the check that
    vouches for the guided body. bf16's mean |difference| is held to twice
    that of two eager chains (the flash backward's atomic dq sums, and
    cuDNN's default backward-data algorithms'), which gamma 10 amplifies
    until the chains part: a loose check."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.models import unet
    from tpu_diffusion_torch.utils import config as config_mod

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    imgs = torch.tanh(torch.randn((COND_BATCH, 64, 64, 3), generator=gen,
                                  device=dev))
    xT = torch.randn(imgs.shape, generator=gen, device=dev)
    for dtype, fraction, steps, repeats in GUIDED_RUNS:
        config = config_mod.get_config(
            "flowers,inpainting,reconstruction_guidance")
        config_mod.apply_overrides(config, [
            "testing.lpips=false", f"diffusion.num_steps={steps}",
            f"conditioning.start_fraction={fraction}",
            f"network.dtype={dtype}"])
        parts = cli.build(config, dev)
        model = unet.randomize_(parts["model"], torch.Generator().manual_seed(
            SEED)).eval().requires_grad_(False)
        graphed_sample, _ = cli.make_samplers(config, parts)
        eager_sample, _ = cli.make_samplers(config, parts, graphed=False)
        cond = parts["likelihood"].sample(
            torch.Generator(device=dev).manual_seed(SEED + 32), imgs)

        def chain(sample):
            return lambda: sample(model, xT, cond, torch.Generator(
                dev).manual_seed(SEED + 33))

        guided = int(steps * fraction)  # steps i < start_step
        name = f"guidance_64px_{dtype}_sf{fraction}"
        # fp32: cuDNN's deterministic backward-data algorithms (its
        # default ones sum with atomics; ROADMAP "Traps")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = dtype == "float32"
        try:
            res = graph_vs_eager(
                torch, card_info, name, chain(eager_sample),
                chain(graphed_sample),
                lambda: graphed_sample.built["graphs"], repeats=repeats,
                per=steps, spread=True, batch=COND_BATCH, steps=steps,
                guided_steps=guided,
                gamma=config.conditioning.gamma, start_fraction=fraction,
                dtype=dtype, cudnn_deterministic=dtype == "float32",
                cut=f"chain cut from 1000 to {steps} steps",
                note_per="per: steps of the chain (*_per: ms per step; at "
                         "start_fraction 1.0 every step is guided)")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launched = res["graph_launches"]
        check(launched.get("flash_attention_bwd", 0) == 5 * guided
              and launched.get("flash_attention_fwd", 0)
              == 5 * (steps + guided),
              f"graphs {name}: replayed {launched}")
        if dtype == "float32":
            check(res["bitwise_equal"],
                  f"graphs {name}: fp32 graphed chain not bitwise equal "
                  f"to the eager one: {res['difference']}")
        del model, parts, graphed_sample, eager_sample
        torch.cuda.empty_cache()


def graphs_phase(torch, card_info, dev, mk):
    """Each fixed-length sampler of the port as a graphed chain against its
    eager loop: DDIM-100 K=3 and K=1 on the CIFAR bench UNet `mk` (the GN
    kernel) through the engine and through the model, the cached amortized
    64px chain of `cli.main`, Euler-Maruyama, the SR256 Euler-20, the MPNN
    design and the unguided protein chain; then a capture that must
    fail."""
    import numpy as np

    from tpu_diffusion_torch import DDPM
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.cli import train_cfm_conditional as cc
    from tpu_diffusion_torch.cli import train_protein
    from tpu_diffusion_torch.core.analytic import marginal_score
    from tpu_diffusion_torch.core.schedules import VPSDE
    from tpu_diffusion_torch.models import unet
    from tpu_diffusion_torch.models.unet_infer import make_fused_apply
    from tpu_diffusion_torch.protein import mpnn
    from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE
    from tpu_diffusion_torch.sampling import ancestral, sde
    from tpu_diffusion_torch.sampling.graph import GraphCache
    from tpu_diffusion_torch.utils import config as config_mod

    # --- DDIM-100 on the CIFAR bench UNet: the main path -----------------
    ddpm = DDPM.create(1000)
    gen = torch.Generator().manual_seed(SEED + 20)
    xT = torch.randn((BATCH, 32, 32, 3), generator=gen).to(dev)

    def ddim(fn, k, graphs):
        def call(xi, i, **kw):
            return fn(xi, i.float() / 1000.0, **kw)
        if k == 1:
            return ancestral.make_ddim_sampler(call, ddpm, num_steps=STEPS,
                                               graphs=graphs)
        return ancestral.make_cached_ddim_sampler(
            lambda xi, i: call(xi, i, mode="encode"),
            lambda xi, i, c: call(xi, i, mode="decode", cache=c), ddpm,
            num_steps=STEPS, encoder_reuse=k, graphs=graphs)

    engine = make_fused_apply(mk)
    for path, fn in (("engine", engine), ("model", mk)):
        graphs = GraphCache(mk)  # one pool for the path's two chains
        for k in (REUSE, 1):
            eager, graphed = ddim(fn, k, None), ddim(fn, k, graphs)
            res = graph_vs_eager(
                torch, card_info, f"ddim_{path}_k{k}", lambda: eager(xT),
                lambda: graphed(xT), graphs, per=STEPS, batch=BATCH,
                steps=STEPS, encoder_reuse=k)
            emit(card_info, phase="graphs", chain=f"ddim_{path}_k{k}",
                 samples_per_s_graphed=BATCH * 1e3
                 / res["wall_ms"]["median"],
                 samples_per_s_eager=BATCH / res["eager_seconds"],
                 device_samples_per_s=BATCH * 1e3
                 / max(res["device_ms"]["median"], 1e-9))
            want = ({"flash_attention_fused", "fused_groupnorm_silu",
                     "fused_resblock"} if path == "engine"
                    else {"flash_attention_fused", "fused_groupnorm_silu"})
            check(set(res["graph_launches"]) == want,
                  f"graphs ddim_{path}_k{k}: kernels replayed "
                  f"{res['graph_launches']}")
        graphs.clear()
    del engine
    torch.cuda.empty_cache()

    # --- the cached amortized 64px chain of cli.main ----------------------
    config = config_mod.get_config("flowers,inpainting,amortized")
    config_mod.apply_overrides(config, [
        "testing.lpips=false", f"diffusion.num_steps={GRAPH_COND_STEPS}"])
    parts = cli.build(config, dev)
    model = unet.randomize_(parts["model"], torch.Generator().manual_seed(
        SEED)).eval().requires_grad_(False)
    graphed_sample, _ = cli.make_samplers(config, parts)
    eager_sample, _ = cli.make_samplers(config, parts, graphed=False)
    lik = parts["likelihood"]
    cgen = torch.Generator(device=dev).manual_seed(SEED + 21)
    imgs = torch.tanh(torch.randn((COND_BATCH, 64, 64, 3), generator=cgen,
                                  device=dev))
    cond = lik.sample(cgen, imgs)
    xT64 = torch.randn(imgs.shape, generator=cgen, device=dev)

    def cond_run(sample):
        return lambda: sample(model, xT64, cond,
                              torch.Generator(dev).manual_seed(SEED + 22))

    graph_vs_eager(torch, card_info, "cached_amortized_64px_k3",
                   cond_run(eager_sample), cond_run(graphed_sample),
                   lambda: graphed_sample.built["graphs"],
                   per=GRAPH_COND_STEPS,
                   batch=COND_BATCH, steps=GRAPH_COND_STEPS,
                   encoder_reuse=COND_REUSE,
                   cut=f"chain cut from 1000 to {GRAPH_COND_STEPS} steps")
    del model, parts, graphed_sample, eager_sample
    torch.cuda.empty_cache()

    guidance_graphs(torch, card_info, dev)

    # --- one SDE sampler: Euler-Maruyama over an exact Gaussian score -----
    vp = VPSDE()

    def score(x, t):
        return marginal_score(vp, 0.8, 0.05**2, x, t[:, None])

    xs = torch.randn((4096, 1), generator=torch.Generator(dev).manual_seed(
        SEED + 23), device=dev)
    sde_graphs = GraphCache()

    def em(graphs):
        return lambda: sde.euler_maruyama(
            torch.Generator(dev).manual_seed(SEED + 24), score, vp, xs, 500,
            return_nan_flag=True, graphs=graphs)

    graph_vs_eager(torch, card_info, "euler_maruyama", em(None),
                   em(sde_graphs), sde_graphs, per=500, samples=4096,
                   steps=500)

    # --- the SR256 eval's Euler-20 (the flash forward at [32,1024,64]) ----
    sr, (h, w, c) = cc.build("superres", "synthetic256", device=dev)
    unet.randomize_(sr, torch.Generator().manual_seed(SEED)).eval()
    sr.requires_grad_(False)
    sgen = torch.Generator(device=dev).manual_seed(SEED + 25)
    low = torch.randn((SR_BATCH, h // 4, w // 4, c), generator=sgen,
                      device=dev)
    x0 = torch.randn((SR_BATCH, h, w, c), generator=sgen, device=dev)
    graphed_sr = cc.make_conditional_sampler("euler", GRAPH_SR_STEPS)
    eager_sr = cc.make_conditional_sampler("euler", GRAPH_SR_STEPS,
                                           graphed=False)
    res = graph_vs_eager(
        torch, card_info, "sr256_euler20",
        lambda: eager_sr(sr, None, x0.shape, low, x0=x0)[0],
        lambda: graphed_sr(sr, None, x0.shape, low, x0=x0)[0],
        lambda: graphed_sr.held["graphs"], per=GRAPH_SR_STEPS,
        batch=SR_BATCH, steps=GRAPH_SR_STEPS)
    check(res["graph_launches"] == {
        "flash_attention_fwd": 5 * GRAPH_SR_STEPS},
          f"graphs sr256_euler20: {res['graph_launches']}")
    del sr, graphed_sr, eager_sr
    torch.cuda.empty_cache()

    # --- the MPNN's design at its published width -------------------------
    net = mpnn.CAProteinMPNN(device=dev)
    net.randomize_(torch.Generator(device=dev).manual_seed(SEED))
    net.eval()
    rng = np.random.default_rng(SEED + 26)
    walk = rng.normal(size=(GRAPH_MPNN_LEN, 3))
    coords = torch.as_tensor(np.cumsum(
        3.8 * walk / np.linalg.norm(walk, axis=-1, keepdims=True), 0),
        dtype=torch.float32, device=dev)
    order = rng.permutation(GRAPH_MPNN_LEN)
    mpnn_graphs = GraphCache(net)
    _, loop = mpnn.make_mpnn_fns(net)
    _, graphed_design = mpnn.make_mpnn_fns(net, mpnn_graphs)
    args = (coords, order, coords.new_ones(GRAPH_MPNN_LEN),
            torch.zeros(GRAPH_MPNN_LEN, dtype=torch.long),
            torch.zeros(GRAPH_MPNN_LEN))

    def design(fn):
        return lambda: fn(*args, generator=torch.Generator(dev).manual_seed(
            SEED + 27))

    graph_vs_eager(torch, card_info, "mpnn_design", design(loop),
                   design(graphed_design), mpnn_graphs, per=GRAPH_MPNN_LEN,
                   residues=GRAPH_MPNN_LEN,
                   note_per="per: decode steps of one design (*_per: ms "
                            "per step)")
    del net, loop, graphed_design
    mpnn_graphs.clear()

    # --- the unguided protein chain at the reference width ----------------
    pargs = train_protein.parser().parse_args(protein_flags([]))
    torch.manual_seed(SEED)
    gvp = train_protein.build_model(pargs, dev).eval().requires_grad_(False)
    diffuser = HoogeboomGraphSDE(num_steps=GRAPH_PROTEIN_STEPS, device=dev)
    pgen = torch.Generator(device=dev).manual_seed(SEED + 28)
    lengths = torch.as_tensor(rng.integers(
        pargs.max_len // 2, pargs.max_len + 1, PROTEIN_SAMPLES), device=dev)
    blob = diffuser.sample_blob(pgen, PROTEIN_SAMPLES, pargs.max_len,
                                lengths=lengths)
    protein_graphs = GraphCache(gvp)

    def chain(graphs):
        return lambda: diffuser.reverse_diffusion_sampling(
            torch.Generator(dev).manual_seed(SEED + 29), blob, gvp,
            graphs=graphs).pos

    graph_vs_eager(torch, card_info, "protein_unguided", chain(None),
                   chain(protein_graphs), protein_graphs,
                   per=GRAPH_PROTEIN_STEPS, batch=PROTEIN_SAMPLES,
                   steps=GRAPH_PROTEIN_STEPS,
                   cut=f"chain cut from 250 to {GRAPH_PROTEIN_STEPS} steps")
    del gvp, blob
    protein_graphs.clear()
    torch.cuda.empty_cache()

    # --- a capture that must fail (a host read in the body), in its own
    # process, so no failed capture touches this one's card state
    probe = (
        "import torch\n"
        "from tpu_diffusion_torch import DDPM, make_ddim_sampler\n"
        "from tpu_diffusion_torch.sampling.graph import GraphCache\n"
        "s = make_ddim_sampler(lambda x, i: x * float(i[0]), DDPM.create("
        "1000), 4, graphs=GraphCache())\n"
        "try:\n"
        "    s(torch.zeros((2, 8, 8, 3), device='cuda'))\n"
        "except RuntimeError as err:\n"
        "    print('raised', type(err).__name__)\n")
    proc = subprocess.run([sys.executable, "-c", probe],
                          capture_output=True, text=True, timeout=120)
    emit(card_info, phase="graphs", chain="failed_capture",
         stdout=proc.stdout.strip(), returncode=proc.returncode)
    check(proc.stdout.startswith("raised"),
          f"graphs: a capture with a host read did not raise: "
          f"{proc.stdout} {proc.stderr[-2000:]}")


TG_STEPS = 10           # steps of each eager and graphed run (train_graphs)
TG_FP32_STEPS = 6       # steps of the fp32 bitwise runs
TG_FP32_BATCH = 8       # the fp32 64px runs' batch, cut from 32
TG_FP32_DIFFUSION = 50  # their diffusion steps (the staleness check's chain)
TG_FUSED_BATCH = 64     # the fused-QKV training step: qkv [64,256,768]
TG_FUSED_STEPS = 5


TG_FP32_OVERRIDES = ["network.dtype=float32", "network.num_res_blocks=1",
                     f"training.batch_size={TG_FP32_BATCH}",
                     f"diffusion.num_steps={TG_FP32_DIFFUSION}"]
TG_REMAT_STEPS = 6      # steps of the rematerialised runs, cut from 10
TG_REMAT_TOL = 1e-6     # rematerialised against plain, of the largest entry
TG_DROPOUT = 0.1        # the rematerialised runs' dropout


def tg_cli_main(torch, dev, overrides, samplers=None, use_checkpoint=False,
                meshed=False):
    """(make, config) for cli.main's flowers,inpainting,amortized config
    with `overrides`: `make(graphed)` builds its Trainer from one seed as
    `cli.main` does (`cli.build`, `init_state`, `make_loss`), the
    ResBlocks rematerialised with `use_checkpoint`, over `make_mesh()` of
    the caller's process group with `meshed`; then calls
    `samplers(config, parts, trainer)` where given."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.data.registry import (get_dataset,
                                                   infinite_batches)
    from tpu_diffusion_torch.parallel.mesh import make_mesh
    from tpu_diffusion_torch.train.trainer import Trainer, make_train_step
    from tpu_diffusion_torch.utils import config as config_mod
    flowers = get_dataset("flowers")("data", train=True)
    config = config_mod.get_config("flowers,inpainting,amortized")
    config_mod.apply_overrides(config, overrides + [f"training.seed={SEED}"])

    def make(graphed):
        torch.manual_seed(SEED)  # the model's own initialisation
        parts = cli.build(config, dev)
        parts["model"].use_checkpoint = use_checkpoint
        mesh = make_mesh() if meshed else None
        state, _ = cli.init_state(config, parts, mesh)
        step = make_train_step(
            cli.make_loss(parts), ema_decay=config.training.ema_decay,
            ema_update_every=config.training.ema_update_every)
        trainer = Trainer(step, state, infinite_batches(
            flowers, config.training.batch_size, seed=SEED), mesh=mesh,
            graphed=graphed)
        if samplers is not None:
            samplers(config, parts, trainer)
        return trainer
    return make, config


def tg_flat(torch, tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def tg_run(torch, make, graphed, steps, deterministic=False, scanned=None,
           after=None):
    """One run of `steps` steps of the Trainer `make(graphed)` builds from
    a fresh state (fit, or fit_scanned with `scanned` = (sampler, chunk)):
    (record, final state flattened, `after(trainer)`). The record holds the
    route, the metric traces, the host clock between per-step metric reads
    (ms; per chunk for fit_scanned), the flash launches that ran per step,
    and for a graphed run each replay's device ms, the captures' seconds
    and pool bytes and the launches a replay makes."""
    import gc
    torch.backends.cudnn.deterministic = deterministic
    try:
        trainer = make(graphed)
        if trainer.graphed:
            trainer.graphs.events = []
        rows = []
        r0 = ran()

        def hook(step, m):
            r = delta(ran(), r0)
            rows.append((time.perf_counter(), step, m,
                         r.get("flash_attention_fwd", 0),
                         r.get("flash_attention_bwd", 0)))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if scanned is None:
            trainer.fit(steps, metrics_hook=hook)
        else:
            trainer.fit_scanned(steps, scanned[0], chunk=scanned[1],
                                base_seed=SEED, metrics_hook=hook)
        torch.cuda.synchronize()
        stamps = [t0] + [r[0] for r in rows]
        done = [0] + [r[1] - trainer.state.step + steps for r in rows]
        rec = {"route": trainer.route(), "graphed": trainer.graphed,
               "seconds": stamps[-1] - t0,
               "wall_ms": [(b - a) * 1e3 / (s1 - s0) for a, b, s0, s1
                           in zip(stamps, stamps[1:], done, done[1:])],
               "flash_per_step": [(f1 - f0, b1 - b0) for (f0, b0), (f1, b1)
                                  in zip([(0, 0)] + [r[3:] for r in rows],
                                         [r[3:] for r in rows])]}
        if scanned is None:
            rec["losses"] = [r[2]["loss"] for r in rows]
            rec["grad_norms"] = [r[2]["grad_norm"] for r in rows]
        else:
            rec["losses"] = [float(x) for r in rows
                             for x in r[2]["loss_trace"]]
            rec["grad_norms"] = [float(x) for r in rows
                                 for x in r[2]["grad_norm_trace"]]
        if trainer.graphed:
            entries = list(trainer.graphs.captured().values())
            rec.update(
                replay_device_ms=[a.elapsed_time(b)
                                  for a, b in trainer.graphs.events],
                capture_s=[e.capture_s for e in entries],
                pool_gb=[e.pool_bytes / 1e9 for e in entries],
                launches_per_replay=entries[0].launches if entries else {},
                replays=[e.replays for e in entries])
        st = trainer.state
        params = list(st.model.parameters())
        final = {"params": tg_flat(torch, params),
                 "ema": tg_flat(torch, st.ema.params.values()),
                 "exp_avg": tg_flat(torch, [st.optimizer.state[p]["exp_avg"]
                                            for p in params]),
                 "exp_avg_sq": tg_flat(torch, [
                     st.optimizer.state[p]["exp_avg_sq"] for p in params]),
                 "generator": st.generator.get_state()}
        extra = after(trainer) if after is not None else None
        del trainer, st, params
    finally:
        torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    return rec, final, extra


def tg_summary(graphed, eager):
    """Per-step wall ms of the steady steps (after the warm-ups and the
    capture: the same step indices for both routes), the replays' device
    ms, and the card's idle share per step, graphed and eager (the eager
    step does the replay's work)."""
    from tpu_diffusion_torch.utils.graphs import WARMUP
    g_wall = quartiles(graphed["wall_ms"][WARMUP + 1:])
    e_wall = quartiles(eager["wall_ms"][WARMUP + 1:])
    dev = quartiles(graphed["replay_device_ms"])
    return {"wall_ms_per_step_graphed": g_wall,
            "wall_ms_per_step_eager": e_wall,
            "replay_device_ms": dev,
            "idle_share_graphed": 1 - dev["median"] / g_wall["median"],
            "idle_share_eager": 1 - dev["median"] / e_wall["median"],
            "capture_s": graphed["capture_s"],
            "pool_gb": graphed["pool_gb"],
            "launches_per_replay": graphed["launches_per_replay"],
            "eager_flash_per_step": sorted(set(eager["flash_per_step"])),
            "route_graphed": graphed["route"],
            "route_eager": eager["route"]}


def tg_equal(a, b):
    return {k: bool(a[k].shape == b[k].shape and a[k].eq(b[k]).all())
            for k in a}


def tg_turns(torch, card_info, name, make, batch, steps=TG_STEPS, **fields):
    """bf16 (or any config whose step sums with atomics): eager, graphed,
    eager, graphed, eager from one seed. The spread is the mean over the
    three pairs of eager runs, the difference the mean over the six
    graphed-eager pairs, of the parameters' and the loss trace's mean
    |difference|; the difference must stay within twice the spread. A
    loss is one rounded fp32 scalar, so the loss trace's bound also allows
    one ulp of the loss (two runs whose parameters differ in their last
    bits tie or differ by an ulp at random)."""
    import itertools

    import numpy as np

    from tpu_diffusion_torch.utils.graphs import WARMUP
    runs = [tg_run(torch, make, graphed, steps)
            for graphed in (False, True, False, True, False)]
    eager = [r for r in runs if not r[0]["graphed"]]
    graphed = [r for r in runs if r[0]["graphed"]]

    def dist(a, b):
        return {"losses": sum(abs(x - y) for x, y in zip(
                    a[0]["losses"], b[0]["losses"])) / steps,
                "params": (a[1]["params"] - b[1]["params"]).abs().mean()
                .item()}

    def mean(pairs):
        ds = [dist(a, b) for a, b in pairs]
        return {k: sum(d[k] for d in ds) / len(ds) for k in ds[0]}

    spread = mean(itertools.combinations(eager, 2))
    diff = mean(itertools.product(graphed, eager))
    ulp = float(np.spacing(np.float32(max(abs(x) for r in runs
                                          for x in r[0]["losses"]))))
    (e1, _, _), (g1, _, _) = eager[0], graphed[0]
    summary = tg_summary(g1, e1)
    emit(card_info, phase="train_graphs", config=name, batch=batch,
         steps=steps, **summary, spread_eager=spread, diff_graphed=diff,
         loss_ulp=ulp,
         losses={"eager": [r[0]["losses"] for r in eager],
                 "graphed": [r[0]["losses"] for r in graphed]},
         wall_ms={"eager": [r[0]["wall_ms"] for r in eager],
                  "graphed": [r[0]["wall_ms"] for r in graphed]},
         **fields)
    check(all(r[0]["graphed"] and r[0]["replays"] == [steps - WARMUP]
              for r in graphed) and not e1["graphed"],
          f"train_graphs {name}: routes {g1['route']} / {e1['route']}, "
          f"replays {[r[0].get('replays') for r in graphed]}")
    check(all(math.isfinite(x) for r in runs
              for x in r[0]["losses"] + r[0]["grad_norms"]),
          f"train_graphs {name}: losses")
    check(diff["params"] <= 2 * spread["params"]
          and diff["losses"] <= 2 * spread["losses"] + ulp,
          f"train_graphs {name}: graphed differs from eager by {diff}, "
          f"twice the eager spread {spread} (losses: + {ulp})")
    # the replays launch the eager step's flash kernels
    flash = {k: v for k, v in g1["launches_per_replay"].items()
             if k.startswith("flash_attention_")}
    want = summary["eager_flash_per_step"]
    check(len(want) == 1 and (flash.get("flash_attention_fwd", 0),
                              flash.get("flash_attention_bwd", 0)) == want[0]
          and all(p == want[0] for p in g1["flash_per_step"]),
          f"train_graphs {name}: flash launches per replay {flash}, per "
          f"graphed step {g1['flash_per_step']}, per eager step {want}")
    del runs, eager, graphed
    torch.cuda.empty_cache()
    return summary


def tg_bitwise(torch, card_info, name, make, batch, steps, scanned=(),
               after=None, phase="train_graphs", **fields):
    """fp32 under cuDNN's deterministic algorithms: the eager run and the
    graphed run equal bitwise (loss and gradient-norm traces, parameters,
    Adam moments, EMA, the Trainer's generator). `scanned`: (sampler,
    chunk) pairs of fit_scanned runs, eager at the first chunk then graphed
    at each, all equal. Returns `after`'s results of the eager and the
    graphed fit, and the graphed fit's record and final state."""
    e, fe, xe = tg_run(torch, make, False, steps, True, after=after)
    g, fg, xg = tg_run(torch, make, True, steps, True, after=after)
    equal = tg_equal(fe, fg)
    traces = e["losses"] == g["losses"] and e["grad_norms"] == g[
        "grad_norms"]
    out = {"fit": tg_summary(g, e)}
    scans = []  # (record, final state, chunk)
    for i, (sampler, chunk) in enumerate(scanned):
        for graphed in ((False, True) if i == 0 else (True,)):
            rec, final, _ = tg_run(torch, make, graphed, steps, True,
                                   scanned=(sampler, chunk))
            scans.append((rec, final, chunk))
    scan_equal = [tg_equal(scans[0][1], s[1]) for s in scans[1:]]
    scan_traces = [s[0]["losses"] == scans[0][0]["losses"]
                   for s in scans[1:]]
    if scans:
        # wall ms per step of each chunk (one host read a chunk); the
        # graphed run at the smallest chunk has a chunk of replays only
        last = scans[-1][0]
        dev = quartiles(last["replay_device_ms"])
        out["fit_scanned"] = {
            "wall_ms_per_step_by_chunk": [
                {"graphed": r["graphed"], "chunk": c, "wall_ms": r["wall_ms"]}
                for r, _, c in scans],
            "replay_device_ms": dev,
            "idle_share_graphed_last_chunk":
                1 - dev["median"] / last["wall_ms"][-1],
            "capture_s": last["capture_s"], "pool_gb": last["pool_gb"],
            "launches_per_replay": last["launches_per_replay"],
            "route_graphed": last["route"],
            "route_eager": scans[0][0]["route"]}
    emit(card_info, phase=phase, config=name, batch=batch,
         steps=steps, deterministic=True, **out, bitwise_equal=equal,
         traces_equal=traces, fit_scanned_bitwise_equal=scan_equal,
         fit_scanned_traces_equal=scan_traces,
         losses={"eager": e["losses"], "graphed": g["losses"]}, **fields)
    check(g["graphed"] and not e["graphed"] and traces
          and all(equal.values()),
          f"train_graphs {name}: fp32 graphed differs from eager: traces "
          f"{traces}, state {equal}")
    check(all(all(q.values()) for q in scan_equal) and all(scan_traces),
          f"train_graphs {name}: fit_scanned runs differ: {scan_equal} "
          f"{scan_traces}")
    return xe, xg, g, fg


def tg_remat_vs_plain(card_info, name, remat, remat_final, plain,
                      plain_final, note):
    """A rematerialised graphed run against the plain graphed run from the
    same seed: the loss traces and the parameters within TG_REMAT_TOL of
    the largest entry (bitwise expected: the recomputation repeats the
    forward's kernels on the same inputs), the flash kernels' launches per
    replay equal (the attention blocks are not checkpointed), and their
    steps' times."""
    from tpu_diffusion_torch.utils.graphs import WARMUP
    losses = max(abs(a - b) for a, b in zip(remat["losses"],
                                            plain["losses"]))
    top = max(abs(x) for x in plain["losses"])
    params = ((remat_final["params"] - plain_final["params"]).abs().max()
              / plain_final["params"].abs().max()).item()
    bitwise = (remat["losses"] == plain["losses"] and bool(
        remat_final["params"].eq(plain_final["params"]).all()))
    flash = [{k: v for k, v in r["launches_per_replay"].items()
              if k.startswith("flash_attention_")} for r in (remat, plain)]
    emit(card_info, phase="train_graphs", config=name,
         check="against_plain_graphed", max_loss_diff_rel=losses / top,
         max_param_diff_rel=params, tol=TG_REMAT_TOL, bitwise=bitwise,
         flash_per_replay_remat=flash[0], flash_per_replay_plain=flash[1],
         replay_device_ms_remat=quartiles(remat["replay_device_ms"]),
         replay_device_ms_plain=quartiles(plain["replay_device_ms"]),
         wall_ms_remat=quartiles(remat["wall_ms"][WARMUP + 1:]),
         wall_ms_plain=quartiles(plain["wall_ms"][WARMUP + 1:]),
         pool_gb_remat=remat["pool_gb"], pool_gb_plain=plain["pool_gb"],
         note=note)
    check(losses <= TG_REMAT_TOL * top and params <= TG_REMAT_TOL,
          f"train_graphs {name}: rematerialised against plain: losses "
          f"{losses / top}, parameters {params}")
    check(flash[0] == flash[1],
          f"train_graphs {name}: flash launches per replay {flash[0]}, "
          f"plain {flash[1]}")


def train_graphs_phase(torch, card_info, dev):
    """The training step as a captured CUDA graph (`train/graph.py`)
    against the eager loop, through the five training CLIs' own build
    functions at their widths: each configuration's Trainer from one seed,
    eager and graphed in turns. bf16 configurations within twice the eager spread;
    fp32 ones bitwise under cuDNN's deterministic algorithms (the 64px
    config at reduced depth, with sampling from the live model after the
    steps, and the protein config through fit and fit_scanned at two
    chunkings); the in-step exact OT loss's declared eager route; C6 (the
    fused-QKV attention's gradient on the card, and a graphed "fused"
    training step moving the qkv weights); the EMA body against the eager
    blend. Returns the wrappers' calls of the phase."""
    from tpu_diffusion_torch.cli import main as cli
    from tpu_diffusion_torch.cli import (train_cfm_conditional, train_cifar10,
                                         train_conditional_mnist,
                                         train_protein)
    from tpu_diffusion_torch.core.ema import EMAState, ema_update
    from tpu_diffusion_torch.data.device_cache import make_protein_sampler
    from tpu_diffusion_torch.data.registry import (get_dataset,
                                                   infinite_batches)
    from tpu_diffusion_torch.kernels import attention
    from tpu_diffusion_torch.losses.cfm import get_matcher, host_ot_pairs
    from tpu_diffusion_torch.protein.data import (get_protein_data,
                                                  protein_batches)
    from tpu_diffusion_torch.protein.gvp import GVPDropout
    from tpu_diffusion_torch.protein.sde import HoogeboomGraphSDE
    from tpu_diffusion_torch.train.trainer import (TrainState, Trainer,
                                                   make_optimizer,
                                                   make_train_step)
    calls0 = {"flash_attention_fused": attention.launches,
              "flash_attention_fwd": attention.flash_fwd_launches,
              "flash_attention_bwd": attention.flash_bwd_launches}
    t_phase = time.perf_counter()

    # --- cli.main flowers,inpainting,amortized --------------------------
    flowers = get_dataset("flowers")("data", train=True)
    make, config = tg_cli_main(torch, dev, [])
    tg_turns(torch, card_info, "cli_main_64px_bf16", make,
             config.training.batch_size,
             note="flowers,inpainting,amortized at its config (93.3M "
                  "parameters, bf16 forward, fp32 parameters, the flash "
                  "kernels at [128,1024,64]) through cli.build, "
                  "init_state and make_loss")
    # the same at full depth in bf16 with use_checkpoint (the flash
    # backward under the recomputation's atomics), dropout on
    make, config = tg_cli_main(torch, dev, [f"network.dropout={TG_DROPOUT}"],
                               use_checkpoint=True)
    tg_turns(torch, card_info, "cli_main_64px_bf16_use_checkpoint", make,
             config.training.batch_size,
             note=f"the same config with use_checkpoint (each ResBlock under "
                  f"torch.utils.checkpoint, its dropout mask drawn first) "
                  f"and dropout {TG_DROPOUT} (the config's is 0.0)")

    # fp32 at reduced depth, and sampling from the live model after
    gen_x = torch.Generator().manual_seed(SEED + 21)
    imgs = torch.from_numpy(flowers.images[:TG_FP32_BATCH]).to(dev)
    xT = torch.randn(imgs.shape, generator=gen_x).to(dev)

    def with_sampler(config, parts, trainer):
        cond_sample, _ = cli.make_samplers(config, parts, graphed=True)
        cond = parts["likelihood"].sample(
            torch.Generator(dev).manual_seed(SEED + 22), imgs)
        trainer.state.model.eval()
        cond_sample(trainer.state.model, xT, cond,
                    torch.Generator(dev).manual_seed(SEED + 23))
        trainer.sample = lambda: cond_sample(
            trainer.state.model.eval(), xT, cond,
            torch.Generator(dev).manual_seed(SEED + 23))
        trainer.cache = cond_sample.built

    def sample_after(trainer):
        x = trainer.sample()
        torch.cuda.synchronize()
        return x, trainer.cache["graphs"].captures

    make, config = tg_cli_main(torch, dev, TG_FP32_OVERRIDES, with_sampler)
    (xe, ce), (xg, cg), _, _ = tg_bitwise(
        torch, card_info, "cli_main_64px_fp32", make, TG_FP32_BATCH,
        TG_FP32_STEPS, after=sample_after,
        note="the 64px config at reduced depth (num_res_blocks 2 -> 1), "
             "fp32 forward (the fp32 flash kernels, no atomics), batch "
             "32 -> 8, 50 diffusion steps")
    stale_equal = torch.equal(xe, xg)
    emit(card_info, phase="train_graphs", config="cli_main_64px_fp32",
         check="sampling_after_training", samples_equal=stale_equal,
         captures={"eager": ce, "graphed": cg},
         note="cli.make_samplers' cached amortized chain (graphed, one "
              "GraphCache on the live model), called before the steps and "
              "after them: the chain must be captured again (2 captures) "
              "and sample the trained weights, equal after graphed and "
              "after eager steps")
    check(stale_equal and ce == cg == 2,
          f"train_graphs: sampling after graphed steps differs from after "
          f"eager ones ({stale_equal}) or was not captured again "
          f"({ce}, {cg})")
    del xe, xg

    # --- use_checkpoint: the same config, its ResBlocks rematerialised ----
    for dropout in (0.0, TG_DROPOUT):
        overrides = TG_FP32_OVERRIDES + [f"network.dropout={dropout}"]
        make, _ = tg_cli_main(torch, dev, overrides, use_checkpoint=True)
        name = f"cli_main_64px_fp32_use_checkpoint_dropout_{dropout}"
        _, _, remat, remat_final = tg_bitwise(
            torch, card_info, name, make, TG_FP32_BATCH, TG_REMAT_STEPS,
            note="the 64px fp32 config at reduced depth with "
                 "use_checkpoint (each ResBlock under torch.utils."
                 f"checkpoint, its dropout mask drawn first), dropout "
                 f"{dropout}: graphed against eager")
        make, _ = tg_cli_main(torch, dev, overrides)
        plain, plain_final, _ = tg_run(torch, make, True, TG_REMAT_STEPS,
                                       deterministic=True)
        tg_remat_vs_plain(card_info, name, remat, remat_final, plain,
                          plain_final,
                          "the graphed rematerialised run against the graphed "
                          "plain run (the same config without "
                          "use_checkpoint), both fp32 under cuDNN's "
                          "deterministic algorithms")

    # --- train_cfm_conditional: SR256 at batch 8 ------------------------
    cc = train_cfm_conditional
    sr_ds = get_dataset("synthetic256")("data", train=True)

    def make_sr(graphed):
        torch.manual_seed(SEED)
        model, dim = cc.build("superres", "synthetic256",
                              cc.ATTENTION_IMPLS["auto"], 0, dev)
        opt = make_optimizer(model.parameters(), 2e-4, warmup=5,
                             grad_clip=1.0)
        state = TrainState.create(model, opt,
                                  torch.Generator(dev).manual_seed(SEED))
        loss = cc.make_loss_fn(get_matcher("icfm", sigma=0.0),
                               cc.make_condition_fn("superres", dim, 20,
                                                    -2.0),
                               "superres", False, -2.0)
        return Trainer(make_train_step(loss, ema_decay=0.9999), state,
                       infinite_batches(sr_ds, SR_BATCH, seed=SEED),
                       graphed=graphed)

    tg_turns(torch, card_info, "cfm_sr256_bf16", make_sr, SR_BATCH,
             note="train_cfm_conditional --task superres --dataset "
                  "synthetic256 (125,375,107 parameters, bf16 forward, the "
                  "flash kernels at [32,1024,64]), warmup 5")

    # --- train_cifar10: OT-CFM, exact pairs on the host, batch 128 --------
    tc = train_cifar10
    cifar = get_dataset("cifar10")("data", train=True)
    pipes = []

    def make_cifar(graphed, exact_in_step=False):
        torch.manual_seed(SEED)
        model = tc.build_model(num_channels=128,
                               attention_impl=tc.ATTENTION_IMPLS["auto"],
                               device=dev)
        opt = make_optimizer(model.parameters(), 2e-4, warmup=5,
                             grad_clip=1.0)
        state = TrainState.create(model, opt,
                                  torch.Generator(dev).manual_seed(SEED))
        batches = infinite_batches(cifar, 128, seed=SEED, flip=True)
        if exact_in_step:
            loss = tc.make_cfm_loss_fn(get_matcher("otcfm", sigma=0.0,
                                                   method="exact"))
        else:
            batches = host_ot_pairs(batches, seed=SEED)
            pipes.append(batches)
            loss = tc.make_cfm_loss_fn(get_matcher("icfm", sigma=0.0),
                                       paired=True)
        return Trainer(make_train_step(loss, ema_decay=0.9999), state,
                       batches, graphed=graphed)

    tg_turns(torch, card_info, "cfm_cifar10_otcfm_host_pairs", make_cifar,
             128, note="train_cifar10 --model otcfm (38.31M parameters, "
                       "bf16 forward, attention at 16x16 dense): exact OT "
                       "pairs on the host between steps (prefetch 2), then "
                       "I-CFM in the step; warmup 5")
    for p in pipes:
        p.close()
    eager_only = make_cifar(True, exact_in_step=True)
    emit(card_info, phase="train_graphs", config="cfm_cifar10_otcfm_in_step",
         graphed=eager_only.graphed, route=eager_only.route(),
         note="exact OT solved inside the step (losses/cfm.py:"
              "exact_ot_permutation): declared eager")
    check(not eager_only.graphed and "host" in eager_only.eager_reason,
          f"train_graphs: the in-step exact OT route {eager_only.route()}")
    del eager_only

    # --- train_conditional_mnist: cfm and otcfm (sinkhorn) -------------
    tcm = train_conditional_mnist
    mnist = get_dataset("mnist")("data", train=True)
    for variant, matcher in (
            ("cfm", get_matcher("icfm", sigma=0.1)),
            ("otcfm", get_matcher("otcfm", sigma=0.1, method="sinkhorn"))):
        def make_mnist(graphed, matcher=matcher):
            torch.manual_seed(SEED)
            model = torch.nn.ModuleDict(
                {"flow": tcm.build_model(32, device=dev)})
            opt = make_optimizer(model.parameters(), 2e-4, warmup=500,
                                 grad_clip=1.0)
            state = TrainState.create(model, opt,
                                      torch.Generator(dev).manual_seed(SEED))
            return Trainer(
                make_train_step(tcm.make_loss_fn(matcher, False),
                                ema_decay=0.9999),
                state, tcm.labeled_batches(mnist, 128, SEED),
                graphed=graphed)

        tg_turns(torch, card_info, f"cond_mnist_{variant}", make_mnist, 128,
                 note="train_conditional_mnist (1,744,161 parameters, bf16 "
                      "forward, no kernel); otcfm: sinkhorn with a column "
                      "drawn per row (torch.multinomial) inside the graph")

    # --- train_protein at batch 32: fit and fit_scanned -----------------
    args = train_protein.parser().parse_args(protein_flags([]))
    diffuser = HoogeboomGraphSDE(num_steps=args.diffusion_steps, device=dev)
    ds = get_protein_data("data/scope", max_len=args.max_len, seed=SEED)
    sampler = make_protein_sampler(ds.positions, ds.lengths,
                                   PROTEIN_TRAIN_BATCH, device=dev)

    def make_protein(graphed):
        torch.manual_seed(SEED)
        model = train_protein.build_model(args, dev)
        opt = make_optimizer(model.parameters(), args.lr, warmup=0,
                             grad_clip=1.0, schedule="constant")
        state = TrainState.create(model, opt,
                                  torch.Generator(dev).manual_seed(SEED))
        loss = train_protein.make_loss_fn(diffuser, args.aux_weight,
                                          args.aux_cutoff, args.distogram)
        return Trainer(make_train_step(loss, ema_decay=0.999), state,
                       protein_batches(ds, PROTEIN_TRAIN_BATCH, seed=SEED),
                       graphed=graphed)

    tg_bitwise(torch, card_info, "protein", make_protein,
               PROTEIN_TRAIN_BATCH, PROTEIN_TRAIN_STEPS,
               scanned=((sampler, PROTEIN_TRAIN_STEPS),
                        (sampler, PROTEIN_TRAIN_STEPS // 2)),
               note="train_protein at the reference width (3,336,001 "
                    "parameters, 112 residues, fp32): fit from "
                    "protein_batches; fit_scanned from make_protein_sampler "
                    "eager at chunk 10, graphed at chunks 10 and 5")
    # --remat with dropout (the CLI exposes no drop_rate: set on the layers)
    remat_args = train_protein.parser().parse_args(protein_flags(["--remat"]))

    def make_protein_drop(graphed, remat=True):
        torch.manual_seed(SEED)
        model = train_protein.build_model(remat_args if remat else args, dev)
        for m in model.modules():
            if isinstance(m, GVPDropout):
                m.rate = TG_DROPOUT
        opt = make_optimizer(model.parameters(), args.lr, warmup=0,
                             grad_clip=1.0, schedule="constant")
        state = TrainState.create(model, opt,
                                  torch.Generator(dev).manual_seed(SEED))
        loss = train_protein.make_loss_fn(diffuser, args.aux_weight,
                                          args.aux_cutoff, args.distogram)
        return Trainer(make_train_step(loss, ema_decay=0.999), state,
                       protein_batches(ds, PROTEIN_TRAIN_BATCH, seed=SEED),
                       graphed=graphed)

    _, _, remat, remat_final = tg_bitwise(
        torch, card_info, "protein_remat", make_protein_drop,
        PROTEIN_TRAIN_BATCH, TG_REMAT_STEPS,
        scanned=((sampler, TG_REMAT_STEPS), (sampler, TG_REMAT_STEPS // 2)),
        note=f"train_protein --remat at the reference width, drop_rate "
             f"{TG_DROPOUT} (each conv layer under torch.utils.checkpoint, "
             f"its dropout masks drawn first): fit, and fit_scanned eager "
             f"at chunk {TG_REMAT_STEPS}, graphed at chunks "
             f"{TG_REMAT_STEPS} and {TG_REMAT_STEPS // 2}")
    plain, plain_final, _ = tg_run(
        torch, lambda graphed: make_protein_drop(graphed, remat=False), True,
        TG_REMAT_STEPS, deterministic=True)
    tg_remat_vs_plain(card_info, "protein_remat", remat, remat_final, plain,
                      plain_final,
                      f"the graphed fit of the rematerialised protein step "
                      f"against the plain one, both at drop {TG_DROPOUT}, "
                      f"fp32 under cuDNN's deterministic algorithms (C7 on "
                      f"the card)")

    # --- C6: the fused-QKV attention's gradient on the card --------------
    grads = []
    gen = torch.Generator(dev).manual_seed(SEED + 31)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        qkv = torch.randn((TG_FUSED_BATCH, 256, 768), generator=gen,
                          device=dev).to(dtype)
        g = torch.randn((TG_FUSED_BATCH, 256, 256), generator=gen,
                        device=dev).to(dtype)
        x = qkv.clone().requires_grad_()
        got, = torch.autograd.grad(attention.flash_attention_fused(x, 4),
                                   x, g)
        x = qkv.clone().requires_grad_()
        want, = torch.autograd.grad(attention.dense_attention(x, 4), x, g)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        grads.append({"dtype": str(dtype), "max_rel_err": err, "tol": tol})
        check(math.isfinite(err) and err <= tol,
              f"train_graphs C6: the fused-QKV gradient in {dtype} is "
              f"{err} off the plain version's")

    def make_fused(graphed):
        torch.manual_seed(SEED)
        model = tc.build_model(num_channels=128, attention_impl="fused",
                               device=dev)
        opt = make_optimizer(model.parameters(), 2e-4, warmup=0,
                             grad_clip=1.0)
        state = TrainState.create(model, opt,
                                  torch.Generator(dev).manual_seed(SEED))
        loss = tc.make_cfm_loss_fn(get_matcher("icfm", sigma=0.0))
        return Trainer(make_train_step(loss, ema_decay=0.9999), state,
                       infinite_batches(cifar, TG_FUSED_BATCH, seed=SEED),
                       graphed=graphed)

    init = make_fused(False)
    qkv0 = {n: p.detach().clone() for n, p in
            init.state.model.named_parameters() if ".qkv." in n}
    del init
    fused_moved = {}

    def qkv_moved(trainer):
        now = dict(trainer.state.model.named_parameters())
        fused_moved.update({n: not torch.equal(now[n], v)
                            for n, v in qkv0.items()})

    rec, _, _ = tg_run(torch, make_fused, True, TG_FUSED_STEPS,
                       after=qkv_moved)
    emit(card_info, phase="train_graphs", config="c6_fused_qkv_training",
         batch=TG_FUSED_BATCH, steps=TG_FUSED_STEPS, gradients=grads,
         route=rec["route"], launches_per_replay=rec["launches_per_replay"],
         qkv_weights_moved=fused_moved,
         note="C6: torch.autograd.grad through flash_attention_fused at "
              "[64,256,768] (4 heads, d=64) against dense_attention's, "
              "max |diff| over the largest entry; then the CIFAR CFM UNet "
              "with attention_impl='fused' trained graphed: the fused "
              "kernel in every replay, its backward the plain version's "
              "vjp")
    check(rec["graphed"] and fused_moved and all(fused_moved.values())
          and rec["launches_per_replay"].get("flash_attention_fused", 0) > 0,
          f"train_graphs C6: qkv weights moved {fused_moved}, per replay "
          f"{rec['launches_per_replay']}")

    # --- the EMA body against the eager blend, on the card ----------------
    gen = torch.Generator(dev).manual_seed(SEED + 41)
    p = {f"p{i}": torch.randn(n, generator=gen, device=dev)
         for i, n in enumerate((37, 4099, 1 << 20))}
    state = EMAState(p)
    ema_ok = []
    for decay in (0.9999, 0.5, 2.0 / 11.0):
        want = {k: state.params[k].clone() for k in p}
        torch._foreach_mul_(list(want.values()), decay)
        torch._foreach_add_(list(want.values()), list(p.values()),
                            alpha=1.0 - decay)
        ema_update(state, p, decay, warmup=False)
        ema_ok.append(all(torch.equal(state.params[k].view(torch.int32),
                                      want[k].view(torch.int32))
                          for k in p))
    emit(card_info, phase="train_graphs", check="ema_blend_bitwise",
         decays=[0.9999, 0.5, 2.0 / 11.0], equal=ema_ok,
         note="ema_blend (mul by d, addcmul by 1 - d from device buffers) "
              "against _foreach_mul_ then _foreach_add_(alpha=1 - d)")
    check(all(ema_ok), f"train_graphs: the EMA body differs from the eager "
                       f"blend on the card: {ema_ok}")
    emit(card_info, phase="train_graphs", seconds=time.perf_counter()
         - t_phase)
    return {"flash_attention_fused": attention.launches
            - calls0["flash_attention_fused"],
            "flash_attention_fwd": attention.flash_fwd_launches
            - calls0["flash_attention_fwd"],
            "flash_attention_bwd": attention.flash_bwd_launches
            - calls0["flash_attention_bwd"]}


# --- the latent-diffusion UNet (models/ldm_unet.py) -------------------------

SD2_CONFIG = "benchmark/configs/sd2-inpaint-unet.json"
SD2_BATCH = 4              # images a chain; classifier-free guidance: 8 rows
SD2_STEPS = 50
SD2_TOKENS = 77
SD2_SCALE = 7.5
# (bh, tq) of the 16 cross-attention calls of a step at 8 rows, by count
XATTN_PATH_SHAPES = {(40, 4096): 5, (80, 1024): 5, (160, 256): 5,
                     (160, 64): 1}
# [rows, C] of the 48 LayerNorm calls of a step at 8 rows, by count
LN_PATH_SHAPES = {(32768, 320): 15, (8192, 640): 15, (2048, 1280): 15,
                  (512, 1280): 3}
L2_BYTES = 50 * 2 ** 20  # the H100's L2 cache


def sd2_model(torch, dev):
    """The SD2-inpainting UNet at its published widths, weights from seed
    SEED by the benchmark's rule; returns (model, its config)."""
    from benchmark.reference.ldm_unet import make_weights
    from tpu_diffusion_torch.models.ldm_unet import create_ldm_unet
    with open(SD2_CONFIG) as f:
        cfg = json.load(f)
    model = create_ldm_unet(dtype=torch.bfloat16, device=dev,
                            **cfg["model"])
    model.load_state_dict(make_weights(cfg["model"], SEED, dev))
    return model.eval().requires_grad_(False), cfg


def layernorm_phase(torch, F, card_info, gen, dev):
    """The LayerNorm kernel (`kernels/layernorm.py`) against its plain
    version at the [rows, C] shapes of an SD2 step at 8 rows, bf16, and
    off them (fp32; C 32 and 2048); two calls bitwise. Each line: the
    kernel's device ms with L2 warm (`ms`, as `time_ms`) and with x read
    from a ring of copies larger than L2 (`hbm_ms`), the bytes bound
    (x read and y written once, the fp32 weight and bias; 6 fp32
    operations an element) and its share at both, the plain version's ms
    and `F.layer_norm` on bf16 (the library yardstick, never called by the
    port). A last line sums a step's 48 calls."""
    import itertools
    from tpu_diffusion_torch.kernels import layernorm
    eps = 1e-5
    step = {}
    cases = [(shape, n, torch.bfloat16)
             for shape, n in sorted(LN_PATH_SHAPES.items())]
    cases += [((2048, 1280), 0, torch.float32), ((300, 32), 0, torch.float32),
              ((5, 32), 0, torch.bfloat16), ((33, 2048), 0, torch.bfloat16)]
    for (rows, c), count, dtype in cases:
        x = (3 * torch.randn((rows, c), generator=gen, device=dev)
             + 1).to(dtype)
        w = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        before = layernorm.launches
        y = layernorm.layer_norm(x, w, b, eps)
        y2 = layernorm.layer_norm(x, w, b, eps)
        want = layernorm.layer_norm_ref(x, w, b, eps)
        torch.cuda.synchronize()
        check(layernorm.launches == before + 2,
              "layer_norm did not count its launches")
        err = (y.float() - want.float()).abs().max().item()
        tol = ((2 ** -7 if dtype == torch.bfloat16 else 1e-5)
               * want.float().abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"layer_norm {rows, c, dtype}: err {err} > {tol}")
        same = torch.equal(y, y2)
        check(same, f"layer_norm {rows, c}: two calls differ")
        times = measure(
            lambda: layernorm.layer_norm(x, w, b, eps),
            lambda: layernorm.layer_norm_ref(x, w, b, eps),
            lambda: F.layer_norm(x, (c,), w.to(dtype), b.to(dtype), eps))
        ring = [x] + [x.clone() for _ in range(
            -(-3 * L2_BYTES // x.nbytes) - 1)]
        turn = itertools.count()
        times["hbm_ms"], _ = time_ms(lambda: layernorm.layer_norm(
            ring[next(turn) % len(ring)], w, b, eps))
        del ring
        n = rows * c
        bound, by = bound_ms(2 * n * x.element_size() + 2 * c * 4, 6 * n,
                             FP32_FLOPS)
        emit(card_info, phase="layernorm", kernel="layer_norm",
             shape=[rows, c], dtype=str(dtype).split(".")[-1],
             count_per_step=count, max_abs_err=err, tol=tol,
             two_calls_bitwise_equal=same, bound_ms=bound, bound_by=by,
             roofline_pct=100 * bound / times["ms"],
             hbm_roofline_pct=100 * bound / times["hbm_ms"], **times)
        for key, val in times.items():
            step[key] = step.get(key, 0.0) + count * val
        step["bound_ms"] = step.get("bound_ms", 0.0) + count * bound
    emit(card_info, phase="layernorm_step",
         calls=sum(LN_PATH_SHAPES.values()), **step)


def xattn_phase(torch, F, card_info, dev, chain=True):
    """The cross-attention kernel against its plain version and SDPA at
    the shapes of an SD2 step at 8 rows and off them; the LayerNorm kernel
    (`layernorm_phase`); the GroupNorm kernel at the SD2 UNet's (C, H*W,
    eps, act) shapes against the plain version; with `chain`, the graphed SD2 guided DDIM chain against its eager chain
    (bitwise), with the launches of a replay of its step."""
    from benchmark.counts.xattn_bounds import xattn as xattn_bound
    from tpu_diffusion_torch.core.schedules import DDPM, scaled_linear_betas
    from tpu_diffusion_torch.kernels import attention, groupnorm
    from tpu_diffusion_torch.models.nn import FusedNormAct
    from tpu_diffusion_torch.sampling.ancestral import (
        amortized_eps_fn, classifier_free_eps_fn, make_ddim_sampler)
    from tpu_diffusion_torch.sampling.graph import GraphCache
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step_ms = {}
    cases = [((bh, tq, SD2_TOKENS), n) for (bh, tq), n in
             sorted(XATTN_PATH_SHAPES.items())]
    cases += [((8, 100, 1), 0), ((8, 1000, 16), 0), ((4, 4096, 128), 0),
              ((3, 77, 100), 0), ((2, 1, 33), 0)]
    for (bh, tq, tk), count in cases:
        q = torch.randn((bh, tq, 64), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((bh, tk, 64), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        before = attention.flash_xattn_launches
        o = attention.flash_cross_attention(q, k, v)
        o2 = attention.flash_cross_attention(q, k, v)
        want = attention.flash_attention_fwd_ref(q, k, v)[0]
        torch.cuda.synchronize()
        err = (o.float() - want.float()).abs().max().item()
        tol = flash_o_tol("bfloat16", want)
        check(attention.flash_xattn_launches == before + 2,
              "flash_cross_attention did not count its launches")
        check(math.isfinite(err) and err <= tol,
              f"cross-attention {bh, tq, tk}: err {err} > {tol}")
        same = torch.equal(o, o2)
        check(same, f"cross-attention {bh, tq, tk}: two calls differ")
        q4, k4, v4 = (x.view(1, bh, -1, 64) for x in (q, k, v))
        times = measure(
            lambda: attention.flash_cross_attention(q, k, v),
            lambda: attention.flash_attention_fwd_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        bound = xattn_bound(bh, tq, tk, 64) * 1e3
        emit(card_info, phase="xattn", kernel="flash_cross_attention",
             shape=[bh, tq, tk, 64], count_per_step=count, max_abs_err=err,
             tol=tol, two_calls_bitwise_equal=same, bound_ms=bound,
             roofline_pct=100 * bound / times["ms"], **times)
        for key, val in times.items():
            step_ms[key] = step_ms.get(key, 0.0) + count * val
        step_ms["bound_ms"] = step_ms.get("bound_ms", 0.0) + count * bound
    emit(card_info, phase="xattn_step", calls=sum(XATTN_PATH_SHAPES.values()),
         **step_ms)
    layernorm_phase(torch, F, card_info, gen, dev)

    model, cfg = sd2_model(torch, dev)
    m = cfg["model"]
    side, rows = m["sample_size"], 2 * SD2_BATCH
    norms = {}

    def hook(module, args):
        x = args[0]
        key = (x.shape[0], x.shape[2], x.shape[3], x.shape[1], module.eps,
               module.act, module.groups)
        norms[key] = norms.get(key, 0) + 1

    handles = [mod.register_forward_pre_hook(hook)
               for mod in model.modules() if isinstance(mod, FusedNormAct)]
    ctx2 = torch.randn((rows, SD2_TOKENS, m["cross_attention_dim"]),
                       generator=gen, device=dev)
    cond2 = torch.randn((rows, side, side, m["in_channels"]
                         - m["out_channels"]), generator=gen, device=dev)
    x_T = torch.randn((SD2_BATCH, side, side, m["out_channels"]),
                      generator=gen, device=dev)
    with torch.no_grad():
        model(torch.cat([x_T.repeat(2, 1, 1, 1), cond2], -1),
              torch.zeros(rows, device=dev), ctx2)
    for h in handles:
        h.remove()
    gn_ms = gn_plain_ms = 0.0
    for (b, h, w, c, eps, act, groups), count in sorted(norms.items()):
        x = (torch.randn((b, h, w, c), generator=gen, device=dev) * 2
             + 0.5).bfloat16()
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        got = groupnorm.fused_groupnorm_silu(x, gamma, beta, None, None,
                                             groups, eps, act)
        want = groupnorm.reference_groupnorm_silu(x, gamma, beta, None, None,
                                                  groups, eps, act)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -7 * max(1.0, want.float().abs().max().item())
        check(math.isfinite(err) and err <= tol,
              f"GroupNorm {b, h, w, c, eps, act}: err {err} > {tol}")
        ms, _ = time_ms(lambda: groupnorm.fused_groupnorm_silu(
            x, gamma, beta, None, None, groups, eps, act))
        plain, _ = time_ms(lambda: groupnorm.reference_groupnorm_silu(
            x, gamma, beta, None, None, groups, eps, act))
        gn_ms += count * ms
        gn_plain_ms += count * plain
        emit(card_info, phase="xattn_gn", shape=[b, h, w, c], eps=eps,
             act=act, count_per_step=count, max_abs_err=err, tol=tol,
             route=groupnorm.gn_route(b, h * w, c, 2)[0], ms=ms,
             plain_ms=plain)
    emit(card_info, phase="xattn_gn_step", calls=sum(norms.values()),
         ms=gn_ms, plain_ms=gn_plain_ms)
    if not chain:
        del model
        torch.cuda.empty_cache()
        return

    sc = cfg["scheduler"]
    ddpm = DDPM.create(sc["num_train_timesteps"], scaled_linear_betas(
        sc["num_train_timesteps"], sc["beta_start"], sc["beta_end"]))

    def unet(x, i):
        return model(x, i, ctx2)

    eps_fn = classifier_free_eps_fn(amortized_eps_fn(unet, cond2), SD2_SCALE)
    eager = make_ddim_sampler(eps_fn, ddpm, num_steps=SD2_STEPS, clip=False)
    graphs = GraphCache(model)
    graphed = make_ddim_sampler(eps_fn, ddpm, num_steps=SD2_STEPS,
                                graphs=graphs, clip=False)
    want = eager(x_T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = eager(x_T)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    got = graphed(x_T)  # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = graphed(x_T)
    torch.cuda.synchronize()
    graphed_s = time.perf_counter() - t0
    chain = next(iter(graphs.chains.values()))
    launches = next(iter(chain.launches.values()))
    check(torch.isfinite(got).all().item(), "SD2 chain: not finite")
    check(torch.equal(got, want), "SD2 graphed chain differs from eager: "
          f"{(got - want).abs().max().item()}")
    check(launches.get("flash_cross_attention") == 16
          and launches.get("flash_attention_fwd") == 16
          and launches.get("layer_norm") == 48,
          f"SD2 step launches {launches}")
    emit(card_info, phase="xattn_chain", rows=rows, steps=SD2_STEPS,
         bitwise_equal=True, launches_per_replay=launches,
         attention=sorted({f"{d['route']} {d['bh']}x{d['tq']}" for d in
                           model.attn_decisions.values()}),
         eager_s=eager_s, graphed_s=graphed_s,
         capture_s=sum(chain.capture_s.values()),
         pool_bytes=sum(chain.pool_bytes.values()),
         max_abs_latent=got.abs().max().item(),
         memory_peak_bytes=torch.cuda.max_memory_allocated(dev))
    del model, graphs, graphed, eager, chain
    torch.cuda.empty_cache()


# --- FLUX.1 Fill [dev]'s transformer (models/flux.py) ----------------------

FLUX_CONFIG = "benchmark/configs/flux1-fill-dev.json"
FLUX_TEXT = 512            # T5 tokens a request
FLUX_HW = (64, 64)         # image tokens: a 1024^2 image's 128^2 latent, 2x2
FLUX_GUIDANCE = 30.0
# the joint attention of every block at one row: [BH, T, d], route "mma"
FLUX_FLASH_SHAPE = (24, FLUX_TEXT + FLUX_HW[0] * FLUX_HW[1], 128)
# the graphed chains: ((double, single) blocks, Euler steps); one period of
# the 1:2 pattern, then the whole model (57 flash calls a step)
FLUX_CHAINS = (((1, 2), 4), ((19, 38), 2))


def flux_phase(torch, F, card_info, dev, chain=True):
    """The flash forward at the joint attention's shape against its plain
    version, two calls bitwise, its time beside the plain version's, SDPA's
    and its bound (`benchmark/counts/bounds.py:flash_fwd`); with `chain`,
    the Fill Euler chain on the shifted grid (`sampling/ode.py`) at the
    published widths, graphed against eager bitwise, at each depth of
    FLUX_CHAINS, and the launches of a second graphed chain, read with the
    counters reset before it: one flash forward a block each replay."""
    from benchmark.counts.bounds import flash_fwd as flash_fwd_bound
    from tpu_diffusion_torch.kernels import REPLAYED, attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bh, t, d = FLUX_FLASH_SHAPE
    per_step = sum(FLUX_CHAINS[-1][0])
    q, k, v = (torch.randn((bh, t, d), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    route = attention.flash_fwd_route(bh, t, d, torch.bfloat16)
    check(route == "mma", f"FLUX flash forward route {route}")
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v)
    o2, lse2 = attention.flash_attention_fwd(q, k, v)
    want_o, want_lse = attention.flash_attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    check(attention.flash_fwd_launches == before + 2,
          "flash_attention_fwd did not count its launches")
    tol = flash_o_tol("bfloat16", want_o)
    err_o = (o.float() - want_o.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    check(math.isfinite(err_o) and err_o <= tol and err_lse <= 1e-4,
          f"FLUX flash forward: o err {err_o} > {tol} or lse err {err_lse}")
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    check(same, "FLUX flash forward: two calls differ")
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    times = measure(lambda: attention.flash_attention_fwd(q, k, v),
                    lambda: attention.flash_attention_fwd_ref(q, k, v),
                    lambda: F.scaled_dot_product_attention(q4, k4, v4))
    bound = flash_fwd_bound(bh, t, d) * 1e3
    emit(card_info, phase="flux_flash", kernel="flash_attention_fwd",
         shape=[bh, t, d], route=route, count_per_step=per_step,
         max_abs_err=err_o, max_abs_err_lse=err_lse, tol=tol,
         two_calls_bitwise_equal=same, bound_ms=bound,
         roofline_pct=100 * bound / times["ms"],
         step_ms=per_step * times["ms"], **times)
    del q, k, v, q4, k4, v4, o, o2, lse, lse2, want_o, want_lse
    torch.cuda.empty_cache()
    if not chain:
        return

    from benchmark.reference.flux import load_weights
    from tpu_diffusion_torch.models.flux import (create_flux, pack_latents,
                                                 pack_mask)
    from tpu_diffusion_torch.sampling.graph import GraphCache
    from tpu_diffusion_torch.sampling.ode import (amortized_velocity,
                                                  odeint_euler,
                                                  shifted_sigmas)
    with open(FLUX_CONFIG) as f:
        cfg = json.load(f)
    m, sc = cfg["model"], cfg["scheduler"]
    lat = (1, 16, 2 * FLUX_HW[0], 2 * FLUX_HW[1])
    x0 = pack_latents(torch.randn(lat, generator=gen, device=dev))
    mask = torch.zeros((1, 1, 16 * FLUX_HW[0], 16 * FLUX_HW[1]), device=dev)
    mask[..., 200:700, 300:900] = 1.0
    cond = torch.cat([pack_latents(torch.randn(lat, generator=gen,
                                               device=dev)),
                      pack_mask(mask)], dim=-1)
    ctx = torch.randn((1, FLUX_TEXT, m["joint_attention_dim"]),
                      generator=gen, device=dev)
    pooled = torch.randn((1, m["pooled_projection_dim"]), generator=gen,
                         device=dev)
    for (double, single), steps in FLUX_CHAINS:
        sizes = dict(m, num_layers=double, num_single_layers=single)
        model = create_flux(dtype=torch.bfloat16, device=dev, **sizes)
        load_weights(model, sizes, SEED, dev)
        model.eval().requires_grad_(False)
        vf = amortized_velocity(
            model.velocity(FLUX_GUIDANCE, ctx, pooled, FLUX_HW), cond)
        grid = shifted_sigmas(
            steps, FLUX_HW[0] * FLUX_HW[1],
            base_image_seq_len=sc["base_image_seq_len"],
            max_image_seq_len=sc["max_image_seq_len"],
            base_shift=sc["base_shift"], max_shift=sc["max_shift"]).to(
                dev, torch.float32)
        t0 = time.perf_counter()
        want = odeint_euler(vf, x0, grid=grid)[0]
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        graphs = GraphCache(model)
        got = odeint_euler(vf, x0, graphs=graphs, grid=grid)[0]  # captures
        torch.cuda.synchronize()
        check(torch.isfinite(got).all().item(), "FLUX chain: not finite")
        check(torch.equal(got, want), f"FLUX {double}+{single} blocks: the "
              f"graphed chain differs from eager: "
              f"{(got - want).abs().max().item()}")
        # a chain of its own, with the counters reset: no launch from
        # Python, one flash forward a block each replay
        attention.flash_fwd_launches = 0
        replayed = REPLAYED.get("flash_attention_fwd", 0)
        t0 = time.perf_counter()
        again = odeint_euler(vf, x0, graphs=graphs, grid=grid)[0]
        torch.cuda.synchronize()
        graphed_s = time.perf_counter() - t0
        replayed = REPLAYED.get("flash_attention_fwd", 0) - replayed
        chain_ = next(iter(graphs.chains.values()))
        launches = {name: n for name, n in
                    next(iter(chain_.launches.values())).items() if n}
        check(torch.equal(again, want), "FLUX: a second graphed chain "
              "differs from eager")
        check(launches == {"flash_attention_fwd": double + single}
              and attention.flash_fwd_launches == 0
              and replayed == steps * (double + single)
              and graphs.captures == 1,
              f"FLUX {double}+{single} blocks: launches a replay "
              f"{launches}, from Python {attention.flash_fwd_launches}, "
              f"replayed {replayed} in {steps} steps, captures "
              f"{graphs.captures}")
        routes = sorted({f"{dd['kind']} {dd['route']} "
                         f"[{dd['bh']},{dd['t']},{dd['d']}]"
                         for dd in model.attn_decisions.values()})
        check(routes == [f"{kind} mma [{bh},{t},{d}]" for kind in
                         ("double", "single")], f"FLUX routes {routes}")
        emit(card_info, phase="flux_chain", blocks=[double, single],
             steps=steps, bitwise_equal=True, launches_per_replay=launches,
             replayed_launches=replayed, attention=routes, eager_s=eager_s,
             graphed_s=graphed_s, graphed_step_ms=1e3 * graphed_s / steps,
             capture_s=sum(chain_.capture_s.values()),
             pool_bytes=sum(chain_.pool_bytes.values()),
             max_abs_latent=got.abs().max().item(),
             memory_peak_bytes=torch.cuda.max_memory_allocated(dev))
        del model, graphs, chain_, vf, want, got, again
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from tpu_diffusion_torch import (DDPM, make_cached_ddim_sampler,
                                     make_ddim_sampler)
    from tpu_diffusion_torch.kernels import adam, attention, build, groupnorm
    from tpu_diffusion_torch.models import nn as nn_mod
    from tpu_diffusion_torch.models import unet

    # fp32 products in full fp32: the fp32 kernel checks compare exactly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_info = card()
    emit(card_info, phase="device", count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         nccl=".".join(map(str, torch.cuda.nccl.version())))

    t0 = time.perf_counter()
    report = build.build_all()
    emit(card_info, phase="build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "ptxas": [ln for ln in v["ptxas"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    dev = torch.device("cuda")
    if sys.argv[1:] == ["--data-parallel"]:
        data_parallel_phase(torch, card_info)
        print(json.dumps({"partial": "--data-parallel: the multi-card "
                                     "data-parallel check only"}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--gn-backward"]:
        gn_backward_phase(torch, F, card_info)
        print(json.dumps({"partial": "--gn-backward: the GroupNorm backward "
                                     "kernel's cases only"}), flush=True)
        return 0
    if sys.argv[1:] == ["--adam"]:
        adam_phase(torch, card_info)
        print(json.dumps({"partial": "--adam: the fused Adam + EMA "
                                     "kernel's cases only"}), flush=True)
        return 0
    if sys.argv[1:] == ["--xattn"]:
        xattn_phase(torch, F, card_info, dev)
        print(json.dumps({"partial": "--xattn: the cross-attention and "
                                     "LayerNorm kernels, the SD2 UNet's "
                                     "GroupNorm shapes and its graphed "
                                     "chain only"}), flush=True)
        return 0
    if sys.argv[1:] == ["--flux"]:
        flux_phase(torch, F, card_info, dev)
        print(json.dumps({"partial": "--flux: the FLUX flash forward and "
                                     "its graphed chains only"}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--kernels"]:
        kernel_phase(torch, F, card_info, ATTN_PATH_SHAPES, GN_PATH_SHAPES)
        resblock_phase(torch, card_info, RES_PATH_SHAPES, unet, dev)
        flash_kernel_phase(torch, F, card_info, FLASH_PATH_SHAPES, dev)
        gn_backward_phase(torch, F, card_info)
        adam_phase(torch, card_info)
        xattn_phase(torch, F, card_info, dev, chain=False)
        flux_phase(torch, F, card_info, dev, chain=False)
        print(json.dumps({"partial": "--kernels: the kernels' cases only"}),
              flush=True)
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
    check(norm_shapes == GN_PATH_SHAPES,
          f"the CIFAR UNet's GroupNorm calls {norm_shapes}")
    check(res_shapes == RES_PATH_SHAPES,
          f"the CIFAR UNet's ResBlocks {res_shapes}")
    totals = kernel_phase(torch, F, card_info, attn_shapes, norm_shapes)
    totals.update(resblock_phase(torch, card_info, res_shapes, unet, dev))
    totals.update(gn_backward_phase(torch, F, card_info))
    totals.update(adam_phase(torch, card_info))
    groupnorm.backward_launches = 0
    adam.launches = 0

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

    # --- the graphed chains (sampling/graph.py) ----------------------------
    from tpu_diffusion_torch.kernels import REPLAYED, resblock
    attention.launches = groupnorm.launches = resblock.launches = 0
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0
    graphs_phase(torch, card_info, dev, models["norm_fused"][0])
    for name, n in (("flash_attention_fused", attention.launches),
                    ("fused_groupnorm_silu", groupnorm.launches),
                    ("fused_resblock", resblock.launches),
                    ("flash_attention_fwd", attention.flash_fwd_launches),
                    ("flash_attention_bwd", attention.flash_bwd_launches)):
        check(n > 0, f"{name} was not launched on the graphed path")
        counts[name] = counts.get(name, 0) + n
    del models
    torch.cuda.empty_cache()

    # --- the conditional path of cli.main at 64px -------------------------
    cond_totals, cond_counts = conditional_phase(torch, F, card_info, dev)
    totals.update(cond_totals)
    for name, n in cond_counts.items():
        counts[name] = counts.get(name, 0) + n

    # --- DDPM training of cli.main at 64px ---------------------------------
    for name, n in train_phase(torch, card_info, dev).items():
        counts[name] += n

    # --- LPIPS and FID in cli.main --mode eval at 64px ---------------------
    counts["flash_attention_fwd"] += eval_metrics_phase(torch, card_info,
                                                        dev)
    torch.cuda.empty_cache()

    # --- CIFAR-10 conditional flow matching: train, then FID ---------------
    import os
    import shutil
    import tempfile
    out = tempfile.mkdtemp(prefix="chip_smoke_cfm_")
    try:
        cfm_train_phase(torch, card_info, out)
        cfm_fid_phase(torch, card_info, out)
        dopri5_graphs_phase(torch, card_info, dev, out)
        torch.cuda.empty_cache()
        # --- the CFM conditional CLIs and the SDE samplers ------------------
        for name, n in cfm_cond_sr256_phase(torch, card_info, out).items():
            counts[name] += n
        # --- parallelism: a one-rank NCCL world and the ring ---------------
        for name, n in parallel_phase(torch, card_info, dev, out).items():
            counts[name] += n
        cfm_cond_64_phase(torch, card_info, out)
        cond_mnist_phase(torch, card_info, out)
        sde_phase(torch, card_info, dev)
        # --- the protein stack at the reference width ------------------------
        protein_phase(torch, card_info, dev, out)
        # --- the evaluation of its guided samples -----------------------------
        protein_eval_work = os.path.join(out, "protein_eval")
        os.makedirs(protein_eval_work)
        protein_eval_phase(torch, card_info, dev,
                           os.path.join(out, "protein_guided"),
                           protein_eval_work)
        # --- the training step as a captured CUDA graph, against eager ------
        for name, n in train_graphs_phase(torch, card_info, dev).items():
            counts[name] += n
        # --- the SD2-inpainting UNet: cross-attention, its graphed chain ---
        xattn_phase(torch, F, card_info, dev)
        # --- FLUX.1 Fill [dev]: the d = 128 flash forward, its chains -----
        flux_phase(torch, F, card_info, dev)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    counts["fused_groupnorm_silu_bwd"] = groupnorm.backward_launches
    counts["fused_adam_ema"] = adam.launches
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
        "fused_groupnorm_silu_bwd": (
            "tpu_diffusion_torch/kernels/csrc/groupnorm_silu.cu",
            "none: the JAX kernel has no backward"),
        "fused_adam_ema": (
            "tpu_diffusion_torch/kernels/csrc/adam_ema.cu",
            "none: XLA fuses optax's update in the JAX step"),
    }
    per = {
        "flash_attention_fused": "one full CIFAR UNet forward at batch 64 "
                                 "(sum over its call shapes); launches: the "
                                 "four DDIM-100 runs, the graphs phase and "
                                 "train_graphs' C6 gradients and graphed "
                                 "'fused' training steps",
        "fused_groupnorm_silu": "one full CIFAR UNet forward at batch 64 "
                                "(sum over its call shapes); launches: the "
                                "four DDIM-100 runs and the graphs phase",
        "flash_attention_fwd": "one full 64px UNet forward at batch 32 (5 "
                               "calls at [128,1024,64]) plus one SR256 "
                               "forward at batch 8 (5 at [32,1024,64]); "
                               "launches: the five conditional sampling "
                               "runs, the 20 training steps, the "
                               "eval_metrics run, the cfm_cond_sr256 "
                               "run (20 steps and its Euler-20 eval) and "
                               "the parallel phase's first meshed run (10 "
                               "steps and its Euler-20 eval), and the "
                               "graphs phase",
        "flash_attention_bwd": "one guidance gradient through the 64px UNet "
                               "at batch 32 (5 calls at [128,1024,64]) plus "
                               "one SR256 training step at batch 8 (5 at "
                               "[32,1024,64]); launches: the guidance run "
                               "and the graphs phase's guided chains "
                               "(their warm-ups and captures), "
                               "the graphed training steps' warm-ups and "
                               "captures (train, cfm_cond_sr256, the "
                               "parallel phase's runs, train_graphs) and "
                               "the eager ones (the eager runs of "
                               "train_graphs and of the parallel phase's "
                               "fp32 check); max_rel_err: the "
                               "largest |dq, dk, dv - plain| over each "
                               "gradient's largest entry",
        "fused_resblock": "one full CIFAR UNet forward through the engine "
                          "at batch 64 (its 5 calls); launches: the two "
                          "engine DDIM-100 runs and the graphs phase; "
                          "library_ms: the port's "
                          "ResBlock module, cuDNN convs with the eager norm "
                          "chain (library_gn_kernel_ms: with the GN kernel)",
        "fused_groupnorm_silu_bwd": "one 64px training step at batch 32 (its "
                                    "61 calls; max_rel_err over each "
                                    "gradient's largest entry); ms: the "
                                    "backward alone; autograd_ms, plain_ms, "
                                    "library_ms: forward and backward "
                                    "through the kernel pair, the plain "
                                    "chain, F.group_norm; launches: every "
                                    "cli.main training and guidance step "
                                    "of the run",
        "fused_adam_ema": "one update of the 64px UNet's 93,347,587 "
                          "parameters, the training cell's mix of 9 "
                          "updates that keep the EMA to 1 that blends it; "
                          "plain_ms: the foreach chain and ema_blend; "
                          "library_ms: torch.optim.Adam(fused=True), Adam "
                          "alone; launches: every update of an fp32 "
                          "training step on the card in the run",
    }
    table = []
    for name, (source, replaces) in meta.items():
        tot = totals[name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "replayed_launches": REPLAYED.get(name, 0),
            "max_abs_err": tot["max_abs_err"],
            **{k: tot[k] for k in ("max_rel_err", "library_gn_kernel_ms",
                                   "library_with_layout_ms", "autograd_ms")
               if k in tot},
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": max(tot["by"], key=tot["by"].get),
            "library_ms": tot["library_ms"],
            "eager_ms": tot["eager_ms"],
            "plain_eager_ms": tot["plain_eager_ms"],
            "library_eager_ms": tot["library_eager_ms"],
            "per": per[name] + "; ms: device time (CUDA-graph replay), "
                               "eager_ms: launched from Python; launches: "
                               "the wrapper's calls (a graphed chain's at "
                               "its warm-up and capture, the graphs phase "
                               "included); replayed_launches: the launches "
                               "replayed from the graphed chains of the "
                               "whole run"})
    print(json.dumps({"kernels": table}), flush=True)
    print(card_info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
