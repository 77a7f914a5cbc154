// Tensor-core building blocks shared by the bf16 attention kernels
// (`attention_fused.cu`, `flash_attention.cu`): `mma.sync` m16n8k16 with
// `ldmatrix` fragments, `cp.async` staging, and the flash forward of one
// block of query rows, written once for any row stride so that it reads
// heads where they lie in a [B, T, 3C] projection (row stride 3C) as well
// as [BH, T, d] slices (row stride d).
//
// Fragment layouts (PTX ISA, m16n8k16, bf16 inputs, fp32 accumulators), with
// lane = 4 * g + c (g = lane / 4, c = lane % 4):
//   A (16 x 16, row): a0 = (row g, k 2c, 2c + 1), a1 = (row g + 8, same k),
//                     a2 = (row g, k 2c + 8, 2c + 9), a3 = (row g + 8, same);
//   B (16 x 8, col):  b0 = (k 2c, 2c + 1, column g), b1 = (k 2c + 8, 2c + 9);
//   C (16 x 8):       c0, c1 = (row g, columns 2c, 2c + 1), c2, c3 = row g + 8.
// So the accumulators of two adjacent 8-column tiles, rounded to bf16, are
// the A fragment of the next product over those 16 columns (p for p.v, ds^T
// for ds^T.q): a product's result is handed on in registers.
//
// Every tile is staged row-major, [rows][D + 8] bf16: the 16-byte pad makes
// the row stride 4 banks (mod 32) for D = 32, 64 and 128, so the eight
// 16-byte rows of one `ldmatrix` matrix fall on distinct banks. `ldmatrix`
// delivers A fragments and the B fragments of a product over the tile's
// columns (q.k^T); `ldmatrix.trans` delivers the B fragments of a product
// over the tile's rows (p.v, ds.k, p^T.g) and A fragments of a tile stored
// transposed. Nothing is stored transposed by scalar stores.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tdt {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 8;  // bf16 elements of padding per staged row

__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (`ex2.approx`, 2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8; register i holds matrix i's (row g, columns 2c, 2c + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As above with each matrix transposed: register i holds matrix i's
// (rows 2c, 2c + 1, column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Asynchronous copies from global to shared memory; with `valid` false the
// destination is filled with zeros and the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows [row0, row0 + ROWS) of a [seq, D] bf16 matrix with
// a row stride of `ld` elements into dst[ROWS][D + 8], by all THREADS
// threads of the block; rows past seq are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_async(const bf16* __restrict__ src,
                                            long long ld, int row0, int seq,
                                            bf16* dst) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += THREADS) {
    const int r = idx / VPR, col = (idx % VPR) * 8;
    const bool valid = row0 + r < seq;
    cp_async16(dst + r * (D + kPad) + col,
               src + (valid ? row0 + r : 0) * ld + col, valid);
  }
}

// The A fragments of 16 rows x (KK * 16) columns of a staged row-major tile
// with row stride LD; `rows` points at the first of the 16 rows.
template <int KK, int LD>
__device__ __forceinline__ void load_a(const bf16* rows, int lane,
                                       uint32_t (&a)[KK][4]) {
  const bf16* p = rows + (lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) ldmatrix_x4(a[kk], p + kk * 16);
}

// acc += a . b^T: a is 16 x (KK * 16) as A fragments, b the first NT * 8
// rows of a staged row-major tile [rows][LD] (the product runs over its
// columns); acc is 16 x (NT * 8) as NT accumulator tiles.
template <int KK, int NT, int LD>
__device__ __forceinline__ void mma_a_bt(const uint32_t (&a)[KK][4],
                                         const bf16* b, int lane,
                                         float (&acc)[NT][4]) {
  const bf16* p = b + (lane % 8 + lane / 16 * 8) * LD + lane / 8 % 2 * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t f[4];  // B fragments of two adjacent 8-row groups of b
      ldmatrix_x4(f, p + j * 16 * LD + kk * 16);
      mma_bf16(acc[2 * j], a[kk], f[0], f[1]);
      mma_bf16(acc[2 * j + 1], a[kk], f[2], f[3]);
    }
}

// acc += a . x: a is 16 x (KK * 16) as A fragments, x the first KK * 16
// rows and NT * 8 columns starting at `x` of a staged row-major tile with
// row stride LD (the product runs over its rows, `ldmatrix.trans`).
template <int KK, int NT, int LD>
__device__ __forceinline__ void mma_a_b(const uint32_t (&a)[KK][4],
                                        const bf16* x, int lane,
                                        float (&acc)[NT][4]) {
  const bf16* p = x + (lane % 16) * LD + lane / 16 * 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t f[4];  // B fragments of two adjacent 8-column groups of x
      ldmatrix_x4_trans(f, p + kk * 16 * LD + j * 16);
      mma_bf16(acc[2 * j], a[kk], f[0], f[1]);
      mma_bf16(acc[2 * j + 1], a[kk], f[2], f[3]);
    }
}

// Round 16 x (KK * 16) accumulators to bf16 A fragments.
template <int KK>
__device__ __forceinline__ void pack_a(const float (&p)[2 * KK][4],
                                       uint32_t (&a)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
}

// Write a warp's 16 x D accumulators, times `mul`, as bf16 to rows
// [row0, row0 + 16) of a matrix with row stride `ld`, rows past seq left
// out. They pass through `stg` ([16][D + 8], the warp's own staging rows) so
// that each lane stores 16 bytes and a row's D values leave as one run.
template <int D>
__device__ __forceinline__ void store_rows16(const float (&acc)[D / 8][4],
                                             float mul0, float mul1,
                                             bf16* stg, bf16* __restrict__ dst,
                                             long long ld, int row0, int seq,
                                             int lane) {
  constexpr int LD = D + kPad, VPR = D / 8;
  const int g = lane / 4, c = lane % 4;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    *reinterpret_cast<uint32_t*>(stg + g * LD + t * 8 + 2 * c) =
        pack_bf16(acc[t][0] * mul0, acc[t][1] * mul0);
    *reinterpret_cast<uint32_t*>(stg + (g + 8) * LD + t * 8 + 2 * c) =
        pack_bf16(acc[t][2] * mul1, acc[t][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * VPR; idx += 32) {
    const int r = idx / VPR, col = (idx % VPR) * 8;
    if (row0 + r < seq)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + col) =
          *reinterpret_cast<const uint4*>(stg + r * LD + col);
  }
}

// Let `Kern` use `bytes` of dynamic shared memory (above the 48 KB default).
// Set once per kernel, on its first launch, so that a launch captured into
// a CUDA graph makes no attribute call.
template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  return err;
}

// ---------------------------------------------------------------------------
// The flash forward of one block: WARPS * 16 query rows starting at q0 of
// one head, against all seq keys.
// ---------------------------------------------------------------------------
//
// q, k, v point at row 0 of the head's [seq, D] matrices, each with a row
// stride of `ld_in` elements; o likewise with `ld_out`; lse (fp32 [seq]) may
// be null. Keys are staged in tiles of 64 rows (K and V, bf16, row-major)
// into a ring of STAGES slots filled by `cp.async`, one commit group per
// tile: the first STAGES tiles are requested at once, so with seq <= 64 *
// STAGES the whole K and V are staged once and the first product starts
// while later keys are in flight; past that a slot is refilled as soon as
// all warps have consumed it. An online softmax in fp32 walks the tiles, in
// base 2 with log2(e) * d^-1/2 folded into one multiply-add per logit. p
// goes from the s accumulators to the p.v product in registers. Keys past
// seq are masked on the last tile only; warps whose rows are all past seq
// skip the arithmetic; rows past seq are not stored.
//
// Rounding: logits are exact bf16 products summed in fp32; the unnormalised
// p (<= 1) is rounded to bf16 for p.v, which accumulates in fp32 and is
// divided by the fp32 row sum at the end (the TPU kernel normalises first,
// then rounds p to v's type).

constexpr int kKeys = 64;  // keys per staged tile

template <int D, int WARPS, int STAGES>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(WARPS * 16 + 2 * STAGES * kKeys) * (D + kPad) *
         sizeof(bf16);
}

template <int D, int WARPS, int STAGES>
__device__ __forceinline__ void attention_fwd_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long ld_in, bf16* __restrict__ o,
    long long ld_out, float* __restrict__ lse, int q0, int seq, float scale,
    bf16* smem) {
  constexpr int LD = D + kPad, KK = D / 16, TILE = kKeys * LD;
  constexpr int ROWS = WARPS * 16, THREADS = WARPS * 32;
  bf16* qs = smem;                 // [ROWS][LD], later the output staging
  bf16* ks = qs + ROWS * LD;       // [STAGES][64][LD]
  bf16* vs = ks + STAGES * TILE;   // [STAGES][64][LD]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = lane % 4;
  const int ntiles = (seq + kKeys - 1) / kKeys;
  const float scale_log2 = scale * kLog2e;

  stage_async<D, ROWS, THREADS>(q, ld_in, q0, seq, qs);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < ntiles) {
      stage_async<D, kKeys, THREADS>(k, ld_in, s * kKeys, seq, ks + s * TILE);
      stage_async<D, kKeys, THREADS>(v, ld_in, s * kKeys, seq, vs + s * TILE);
    }
    cp_async_commit();  // group s: tile s (and q in group 0)
  }

  const bool active = q0 + warp * 16 < seq;  // warp-uniform
  uint32_t qa[KK][4];
  cp_async_wait<STAGES - 1>();  // group 0 (q) has landed
  __syncthreads();
  load_a<KK, LD>(qs + warp * 16 * LD, lane, qa);
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled logits
  float l[2] = {0.f, 0.f};  // this thread's share of the two row sums
  float acc[D / 8][4];
  zero(acc);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 1>();  // groups 0 .. i have landed
    __syncthreads();
    const int slot = i % STAGES;
    if (active) {
      float s[8][4];
      zero(s);
      mma_a_bt<KK, 8, LD>(qa, ks + slot * TILE, lane, s);
      const int k0 = i * kKeys;
      if (k0 + kKeys > seq) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + t * 8 + 2 * c + e % 2 >= seq) s[t][e] = -INFINITY;
      }
      // rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          tmax = fmaxf(tmax, fmaxf(s[t][2 * h], s[t][2 * h + 1]));
        // the 4 lanes of a row are adjacent lanes of one quad
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        // finite: key k0 < seq is valid
        const float mnew = fmaxf(m[h], tmax * scale_log2);
        const float alpha = fast_exp2(m[h] - mnew);  // 0 on the first tile
        m[h] = mnew;
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[t][2 * h + e];
            x = fast_exp2(fmaf(x, scale_log2, -mnew));
            psum += x;
          }
        l[h] = l[h] * alpha + psum;
#pragma unroll
        for (int t = 0; t < D / 8; ++t) {
          acc[t][2 * h] *= alpha;
          acc[t][2 * h + 1] *= alpha;
        }
      }
      uint32_t pa[kKeys / 16][4];
      pack_a<kKeys / 16>(s, pa);
      mma_a_b<kKeys / 16, D / 8, LD>(pa, vs + slot * TILE, lane, acc);
    }
    if (i + STAGES < ntiles) {
      __syncthreads();  // every warp has consumed the slot
      const int r0 = (i + STAGES) * kKeys;
      stage_async<D, kKeys, THREADS>(k, ld_in, r0, seq, ks + slot * TILE);
      stage_async<D, kKeys, THREADS>(v, ld_in, r0, seq, vs + slot * TILE);
    }
    cp_async_commit();
  }
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float total = l[h];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    inv[h] = 1.f / total;
    const int row = q0 + warp * 16 + lane / 4 + 8 * h;
    if (lse != nullptr && c == 0 && row < seq)
      lse[row] = m[h] * kLn2 + logf(total);
  }
  // the warp's own 16 rows of qs were read (into qa) by this warp only
  store_rows16<D>(acc, inv[0], inv[1], qs + warp * 16 * LD, o, ld_out,
                  q0 + warp * 16, seq, lane);
}

}  // namespace tdt
