"""Variants of the "wgmma" ResBlock kernel, timed in turns on the card.

    python -m tpu_diffusion_torch.kernels.resblock_variants [name ...]
    python -m tpu_diffusion_torch.kernels.resblock_variants --clocks

Writes copies of `csrc/resblock.cu` with text sites replaced (a design
variant, or a diagnostic that leaves out part of the work and so computes
a wrong result), builds them beside the kernels in parallel, and
times `fused_resblock` through each at the CIFAR engine's three shapes
([64, 32, 32, Cin] -> 128 bf16, Cin 128 with the identity skip, 256 and 384
with the 1x1 skip, FiLM), in turns with the kept kernel (`chip_smoke.time_ms`, CUDA-graph replay), and
checks each variant that computes the function against
`resblock_reference`. Prints one JSON line per (variant, shape) and each
build's register and spill line. `--clocks` instead builds a copy with
`clock64()` stamps in one conv1 block and prints, per consumer warpgroup,
the clocks of its phases and its waits at the engine's three shapes. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

# name: [(text in the kernel, text that replaces it)], each site found once
VARIANTS = {
    # two taps' products in flight instead of one
    "in_flight_2": [("constexpr int kInFlight = 1;",
                     "constexpr int kInFlight = 2;")],
    # six weight slots instead of eight
    "stages_6": [("constexpr int kStages = 8;", "constexpr int kStages = 6;")],
    # SiLU by the fast intrinsics (differs from PyTorch's rounding)
    "fast_silu": [("  return v / (1.f + expf(-v));",
                   "  return __fdividef(v, 1.f + __expf(-v));")],
    # the activation pass: 256 pixels a block, or eight vectors in flight
    "act_256px": [("constexpr int kActPixels = 128;",
                   "constexpr int kActPixels = 256;")],
    "act_unroll_8": [("#pragma unroll 4\n  for (int i = threadIdx.x; i < nvec;",
                      "#pragma unroll 8\n  for (int i = threadIdx.x; i < nvec;")],
    # diagnostic: no SiLU in the activation pass (wrong result)
    "act_no_silu": [("  return v / (1.f + expf(-v));", "  return v;")],
    # diagnostic: no products (wrong result)
    "no_products": [(
        "      tdt::wgmma_m64n128k16_ss<1>(acc[0], da0 + 2 * kk, db + 128 * kk, 1);\n"
        "      tdt::wgmma_m64n128k16_ss<1>(acc[1], da1 + 2 * kk, db + 128 * kk, 1);\n",
        "")],
    # diagnostic: no GN + SiLU pass (the convs read stale activations)
    "no_act": [("      cudaError_t e = launch_act(a, act, batch, stream);",
                "      cudaError_t e = cudaSuccess;")],
}
DIAGNOSTIC = ("no_products", "no_act", "act_no_silu")
# clock stamps in one conv1 block (tile 1, image 5) per consumer warpgroup:
# 0 start, 16 + c end of chunk c's issue, 3 products done, 8 end; 4-6 the
# clocks spent waiting for weight tiles, for products and for A stages
CLOCKS = [
    ("namespace {\n",
     "__device__ long long g_clk[1024];\n"
     "#define STAMP(k) do { if (stamp_on) g_clk[(k)] = clock64(); } while (0)\n"
     "extern \"C\" int read_clocks(void* dst) {\n"
     "  return cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk));\n}\n"
     "namespace {\n"),
    ("  tdt::regs_alloc<240>();\n  const int tid = threadIdx.x;  // 0..255\n",
     "  tdt::regs_alloc<240>();\n  const int tid = threadIdx.x;  // 0..255\n"
     "  const bool stamp_on = blockIdx.x == 1 && blockIdx.y == 0 && "
     "blockIdx.z == 5 && a.out_partials != nullptr && tid % 128 == 0;\n"
     "  const int sb = tid / 128 * 512;\n"
     "  long long w_full = 0, w_done = 0, w_a = 0;\n"
     "  STAMP(sb + 0);\n"),
    ("    tdt::mbar_wait(full + slot, (q / kStages) & 1);\n",
     "    { const long long t0 = clock64();\n"
     "      tdt::mbar_wait(full + slot, (q / kStages) & 1);\n"
     "      w_full += clock64() - t0; }\n"),
    ("    tdt::wgmma_wait<kInFlight>();\n",
     "    { const long long t0 = clock64();\n"
     "      tdt::wgmma_wait<kInFlight>();\n"
     "      w_done += clock64() - t0; }\n"),
    ("    tdt::mbar_wait(a_full + (c & 1), (c >> 1) & 1);\n",
     "    { const long long t0 = clock64();\n"
     "      tdt::mbar_wait(a_full + (c & 1), (c >> 1) & 1);\n"
     "      w_a += clock64() - t0; }\n"),
    ("    ends[c & 1] = q;\n    issued = c + 1;\n",
     "    ends[c & 1] = q;\n    issued = c + 1;\n    STAMP(sb + 16 + c);\n"),
    ("  consumer_sync(1);  // every product is done",
     "  STAMP(sb + 3);\n  if (stamp_on) { g_clk[sb + 4] = w_full; "
     "g_clk[sb + 5] = w_done; g_clk[sb + 6] = w_a; }\n"
     "  consumer_sync(1);  // every product is done"),
    ("  // The identity skip (its tile of x, by TMA, in the output tile's layout)\n",
     "  STAMP(sb + 9);\n"
     "  // The identity skip (its tile of x, by TMA, in the output tile's layout)\n"),
    ("  tdt::fence_async_smem();  // the tile, visible to the TMA store\n  consumer_sync(1);\n",
     "  tdt::fence_async_smem();  // the tile, visible to the TMA store\n  consumer_sync(1);\n"
     "  STAMP(sb + 8);\n"),
]
SHAPES = [(64, 32, 128, 128, False), (64, 32, 256, 128, True),
          (64, 32, 384, 128, True)]


def _build(names, sites=VARIANTS):
    from tpu_diffusion_torch.kernels import build
    src = (build.CSRC / "resblock.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in sites[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: site not found once: {old!r}")
            text = text.replace(old, new)
        cu = build.BUILD_DIR / f"resblock_{name}.cu"
        so = build.BUILD_DIR / f"resblock_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "conv3x3_wgmma_kernel" in line and "Function properties" in line:
                print(name, " | ".join(lines[i + 1:i + 3]), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def clocks(torch, chip_smoke, resblock):
    """Print the clock stamps of one conv1 block at the engine's shapes."""
    lib = _build(["clocks"], {"clocks": CLOCKS})["clocks"]
    fn = lib.resblock_forward
    kept = resblock._entry()
    fn.argtypes, fn.restype = kept.argtypes, kept.restype
    lib.read_clocks.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    resblock._entry = lambda: fn
    try:
        for b, hw, cin, cout, skip in SHAPES[:3]:
            args = chip_smoke.resblock_inputs(torch, gen, dev, b, hw, cin,
                                              cout, True, skip,
                                              torch.bfloat16)
            for _ in range(3):
                resblock.fused_resblock(*args)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 1024)()
            lib.read_clocks(ctypes.addressof(buf))
            c = list(buf)
            for wgi in (0, 1):
                o = wgi * 512
                marks = [c[o]] + [c[o + 16 + k] for k in range(cin // 32)]
                print(json.dumps({
                    "shape": [b, hw, hw, cin], "warpgroup": wgi,
                    "chunks": [marks[k + 1] - marks[k]
                               for k in range(len(marks) - 1)],
                    "drain": c[o + 3] - marks[-1],
                    "epilogue": c[o + 8] - c[o + 3],
                    "epilogue_sums": c[o + 9] - c[o + 3],
                    "epilogue_tile": c[o + 8] - c[o + 9],
                    "total": c[o + 8] - c[o],
                    "wait_weights": c[o + 4], "wait_products": c[o + 5],
                    "wait_input": c[o + 6]}), flush=True)
    finally:
        resblock._entry = lambda: kept


def main():
    import torch

    import chip_smoke
    from tpu_diffusion_torch.kernels import resblock
    if not torch.cuda.is_available():
        raise SystemExit("resblock_variants: needs a CUDA card")
    if sys.argv[1:] == ["--clocks"]:
        return clocks(torch, chip_smoke, resblock)
    names = sys.argv[1:] or list(VARIANTS)
    libs = _build(names)
    kept = resblock._entry()
    entries = {"kept": kept}
    for name, lib in libs.items():
        fn = lib.resblock_forward
        fn.argtypes, fn.restype = kept.argtypes, kept.restype
        entries[name] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(chip_smoke.card(), flush=True)
    try:
        for b, hw, cin, cout, skip in SHAPES:
            args = chip_smoke.resblock_inputs(torch, gen, dev, b, hw, cin,
                                              cout, True, skip,
                                              torch.bfloat16)
            want = resblock.resblock_reference(*args)
            ref_max = want.float().abs().max().item()
            order = ["kept"] + names + ["kept"]
            for name in order:
                resblock._entry = lambda fn=entries[name]: fn
                got = resblock.fused_resblock(*args)
                err = (got.float() - want.float()).abs().max().item()
                ms = chip_smoke.time_ms(
                    lambda: resblock.fused_resblock(*args))[0]
                print(json.dumps({
                    "variant": name, "shape": [b, hw, hw, cin], "cout": cout,
                    "ms": ms, "max_abs_err": err, "max_abs_ref": ref_max,
                    "diagnostic": name in DIAGNOSTIC}), flush=True)
    finally:
        resblock._entry = lambda: kept


if __name__ == "__main__":
    main()
