"""Clock breakdown of the TMA / `wgmma` flash forward, on the card.

    python -m tpu_diffusion_torch.kernels.fwd_clocks

Writes a copy of `csrc/flash_attention.cu` with `clock64()` stamps in one
work item of one persistent block (each consumer warpgroup's first thread),
builds it beside the kernels, runs the forward at the 64px UNet's shape
[128, 1024, 64] bf16, and prints per warpgroup the clocks of the phases of
an item: the wait for its q tile, the first key tile, then per later key
tile the issue of its products (waits for the turn and the tiles included),
the wait for s, the softmax, and the wait for p.v with the rescaling; the
last tile and the epilogue. Then it times the forward and SDPA in turns
(`chip_smoke.time_ms`, CUDA-graph replay). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess

# (text in the kernel, text that replaces it): one stamp site each
_STAMPS = [
    ("namespace {\n",
     "__device__ unsigned long long g_clk[512];\n"
     "#define STAMP(k) do { if (stamp_on && threadIdx.x % 128 == 0) "
     "g_clk[(k)] = clock64(); } while (0)\n"
     "extern \"C\" int read_clocks(void* dst) {\n"
     "  return cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk));\n}\n"
     "namespace {\n"),
    ("    tdt::zero(acc);\n    float alpha[2];\n",
     "    tdt::zero(acc);\n    float alpha[2];\n"
     "    const bool stamp_on = blockIdx.x == 3 && it == 2;\n"
     "    STAMP(wg * 256 + 0);\n"),
    ("    mbar_wait(q_full + qb, it / 2 & 1);\n",
     "    mbar_wait(q_full + qb, it / 2 & 1);\n    STAMP(wg * 256 + 1);\n"),
    ("    for (int j = 1; j < nk; ++j) {\n      turn_wait(wg);\n",
     "    for (int j = 1; j < nk; ++j) {\n      STAMP(wg * 256 + 2 + 5 * j);\n"
     "      turn_wait(wg);\n"),
    ("      turn_pass(wg);\n      wgmma_wait<1>();",
     "      turn_pass(wg);\n      STAMP(wg * 256 + 3 + 5 * j);\n"
     "      wgmma_wait<1>();"),
    ("      fence_regs(s);\n      softmax(alpha);\n",
     "      fence_regs(s);\n      STAMP(wg * 256 + 4 + 5 * j);\n"
     "      softmax(alpha);\n      STAMP(wg * 256 + 5 + 5 * j);\n"),
    ("      tdt::pack_a<BN / 16>(s, pa);\n    }\n",
     "      tdt::pack_a<BN / 16>(s, pa);\n      STAMP(wg * 256 + 6 + 5 * j);\n"
     "    }\n"),
    ("    jj += nk;\n", "    STAMP(wg * 256 + 100);\n    jj += nk;\n"),
    ("    if (wt == 0) mbar_arrive(q_empty + qb);\n",
     "    if (wt == 0) mbar_arrive(q_empty + qb);\n"
     "    STAMP(wg * 256 + 101);\n"),
]


def _build():
    from tpu_diffusion_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in _STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"stamp site not found once: {old!r}")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "flash_attention_clocks.cu"
    so = build.BUILD_DIR / "flash_attention_clocks.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i,
                                        ctypes.c_float, i, p]
    lib.read_clocks.argtypes = [p]
    return lib


def main():
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from tpu_diffusion_torch.kernels import attention
    if not torch.cuda.is_available():
        raise SystemExit("fwd_clocks: needs a CUDA card")
    bh, t, d = 128, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device="cuda")
    lib = _build()
    route = attention.FWD_ROUTES.index("wgmma")
    for _ in range(3):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, t, d, d ** -0.5, route,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 512)()
    lib.read_clocks(ctypes.addressof(buf))
    c = list(buf)
    nk = t // 128
    for wg in (0, 1):
        b = wg * 256
        tile = [c[b + 2 + 5 * j: b + 7 + 5 * j] for j in range(1, nk)]
        phases = [sum(x[e + 1] - x[e] for x in tile) / len(tile)
                  for e in range(4)]
        last = b + 2 + 5 * (nk - 1)  # the start of the last key tile
        per_tile = (c[last] - c[b + 7]) / (nk - 2)
        print(f"warpgroup {wg}: q wait {c[b + 1] - c[b]}, first tile "
              f"{c[b + 7] - c[b + 1]}, per later tile {per_tile:.0f} = "
              f"issue {phases[0]:.0f} + wait s {phases[1]:.0f} + softmax "
              f"{phases[2]:.0f} + wait p.v, rescale {phases[3]:.0f} + rest; "
              f"last tile {c[b + 100] - c[last]}, epilogue "
              f"{c[b + 101] - c[b + 100]}, item {c[b + 101] - c[b]} clocks")
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    for _ in range(3):
        kern = chip_smoke.time_ms(
            lambda: attention.flash_attention_fwd(q, k, v), iters=50)[0]
        sdpa = chip_smoke.time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4), iters=50)[0]
        print(f"device ms: kernel {kern:.5f}, SDPA {sdpa:.5f}")


if __name__ == "__main__":
    main()
