// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of tpu_diffusion/kernels/attention.py:
//   forward   `_flash_attention_3d` (body `_attn_fwd_kernel`), and
//   backward  `_flash_attention_bwd_3d` (bodies `_attn_bwd_dq_kernel` and
//             `_attn_bwd_dkdv_kernel`),
// the Pallas kernels behind the JAX `flash_attention` custom VJP.
//
// Function, per (batch*head) slice of [BH, T, d] q, k, v:
//   forward   o = softmax(q * d^-1/2 . k^T) . v, lse = rowwise logsumexp
//             (fp32), logits fp32 whatever the input type;
//   backward  p = exp(q * d^-1/2 . k^T - lse) recomputed in fp32,
//             dp = g . v^T, ds = p * (dp - delta) with delta = rowsum(g * o)
//             (computed by the caller), dq = ds . k * d^-1/2,
//             dv = p^T . g, dk = ds^T . q * d^-1/2.
//
// Bound on the H100: at the 64px UNet's shape ([128, 1024, 64] bf16) the
// forward's 34.4 GFLOP (s and p.v, 4 T^2 d per slice) need 34.7 us at the
// bf16 tensor-core rate against 20 us for its 68 MB, and the backward's
// 85.9 GFLOP (s, dp, dq, dk and dv, 10 T^2 d per slice) need 86.9 us
// against 35 us for its 118 MB, so both are bound by operations: the
// design is about keeping the tensor cores fed and doing no product twice.
//
// bf16 inputs run on the tensor cores with fp32 accumulators (`mma.sync`
// m16n8k16, whose fragment, staging and softmax code is shared with the
// fused-QKV kernel through attention_mma.cuh; `wgmma` in the forward and
// the backward at the UNet's shape). Every tile is staged row-major once,
// asynchronously (`cp.async` into padded rows, or TMA into swizzled rows);
// `ldmatrix` and `ldmatrix.trans` or the `wgmma` descriptors deliver the
// operands (nothing is stored transposed by scalar stores, no fragment is
// gathered word by word); a product's accumulators, rounded to bf16, are
// the next product's A fragments in registers. The T x T logits never
// reach device memory.
//   Forward, three routes that the caller picks (`flash_fwd_route` in
//   kernels/attention.py) and the entry point refuses where they do not fit:
//   "wgmma" (`flash_fwd_tma_kernel`, bf16, d = 64, T a multiple of 128,
//   the 64px UNet's shape): FlashAttention-3's design, a persistent block
//   per SM of one producer and two consumer warpgroups, TMA, mbarriers and
//   `wgmma` (see the kernel); at [128, 1024, 64] its 128-key tile costs a
//   block ~2450 clocks, of which the tensor cores need ~1050; each
//   warpgroup's softmax takes 1050-1450 of them and overlaps the other's
//   products only in part, even with the warpgroups taking turns. Not the
//   `ex2` units (16384 exponentials a tile, ~1024 clocks at 16 a clock per
//   SM) but the consumer warps' issue holds it at ~2.4x its bound: moving a
//   quarter of the exponentials to the FMA units made it 8% slower.
//   "mma" (`flash_fwd_mma_kernel`, other bf16 shapes):
//   `tdt::attention_fwd_block`, 128 query rows per block (8 warps), keys in
//   a ring of four 64-row slots of which the first four are requested at
//   once, online softmax in base 2, masked on the last tile only (any T).
//   "scalar" (`flash_fwd_kernel`): fp32, below.
//   Backward: one pass, 10 T^2 d per slice and no product twice. A block
//   owns 128 key rows (8 warps of 16) and walks the query tiles; s^T and
//   dp^T are computed once, dk and dv accumulate in registers, and the
//   block's share of dq (ds . k over its 128 keys) is added to an fp32
//   accumulator in device memory with atomic adds, which a small kernel then
//   scales and rounds to bf16. The caller zeroes the accumulator. The
//   atomic sums reach each dq element from T / 128 blocks in an order that
//   changes from run to run, so dq's last fp32 bits (and, rarely, its bf16
//   rounding) can differ between two calls on the same inputs; dk and dv
//   are deterministic. p = 2^(s d^-1/2 log2e - lse log2e): one multiply-add
//   and one `ex2` per logit. Two kernels share that design:
//   `flash_bwd_tma_kernel` for d = 64 and T a multiple of 128 (the UNet's
//   shape): `wgmma` for all five products, tiles by TMA, the warpgroups
//   synchronised by mbarriers only, dq added by bulk reduce; and
//   `flash_bwd_mma_kernel` for every other shape: `mma.sync` with `ldmatrix`
//   fragments, tiles by `cp.async` into a two-slot ring, dq added with
//   vector `red.global.add`, keys and query rows past T zero-filled and
//   their p forced to 0 on edge tiles only (any T).
// For fp32 inputs the scalar kernels (`flash_fwd_kernel`,
// `flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`) do every product with
// fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor cores' 989); the
// scalar backward is two kernels that each recompute s and dp (14 T^2 d, no
// atomics), with a floor of ~0.5 ms forward and ~1.8 ms backward at that
// shape. A scalar block owns 64 rows (query rows for the forward and dq
// kernels, key rows for dk/dv) and walks the other side in tiles of 64
// staged in shared memory as fp32 with padded row strides; 256 threads run
// as a 16 x 16 grid, each computing a 4 x 4 block of the 64 x 64 logits
// (rows ty + 16i, columns tx + 16j) and a 4 x d/16 block of its output.
// The forward keeps a running max and sum per row (online softmax, any T:
// the last tile is masked, rows past T compute and store nothing); the
// backward takes p from the saved lse.
//
// Rounding: the TPU forward normalises p over the whole row, rounds it to
// v's type and then multiplies by v. The scalar forward keeps p in fp32,
// accumulates p.v in fp32 and divides by the row sum once at the end; the
// tensor-core forward rounds the unnormalised p (<= 1) to bf16 for the p.v
// product, accumulates in fp32 and divides at the end. So a bf16 output
// differs from the TPU kernel's by the rounding of p to bf16 (2^-9 relative
// per term) plus the output's own rounding; an fp32 output differs only in
// summation order. The tensor-core logits are exact bf16 products summed
// in fp32, scaled by d^-1/2 after the product (the TPU kernel scales the
// fp32 q before it): a difference at fp32 rounding level; `ex2.approx` adds
// 2 ulp of fp32 to p. The tensor-core backward rounds p and ds to bf16 for
// the products that take them (dq, dk, dv), where the TPU kernels keep them
// fp32; the gradients, bf16 themselves, differ by a few units of their
// last place.

#include <math.h>
#include <cuda.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // rows per block, and rows per staged tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kPS = kTile + 1;  // padded row stride of a 64 x 64 fp32 tile

// Stage rows [row0, row0 + 64) of a [seq, D] slice into dst[64][D + 1] as
// fp32 times `mul`; rows past seq are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int row0, int seq, float* dst,
                                          float mul) {
  constexpr int VEC = tdt::vec16<float>();
  constexpr int VPR = D / VEC;
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float v[VEC];
    if (row0 + r < seq) {
      tdt::load16(src + static_cast<long long>(row0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * LD + c + i] = v[i] * mul;
  }
}

// s[i][j] = sum_k a[ty + 16i][k] * b[tx + 16j][k] over the D columns of two
// staged [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void dot_abt(const float* __restrict__ a,
                                        const float* __restrict__ b, int ty,
                                        int tx, float (&s)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_k p[ty + 16i][k] * v[k][tx + 16j] for a [64][65] tile p
// and a staged [64][D + 1] tile v.
template <int D>
__device__ __forceinline__ void acc_pv(const float* __restrict__ p,
                                       const float* __restrict__ v, int ty,
                                       int tx, float (&acc)[4][D / 16]) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float pv[4], vv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPS + k];
#pragma unroll
    for (int j = 0; j < NC; ++j) vv[j] = v[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// Reduce over the 16 threads of a row (adjacent lanes of one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0,
                                           int seq, int ty, int tx,
                                           const float (&acc)[4][D / 16],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[static_cast<long long>(row) * D + tx + 16 * j] = acc[i][j] * mul;
  }
}

// ---------------------------------------------------------------------------
// Scalar forward, fp32 only: one block per (64-row query tile, bh).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int seq, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][LD], q * scale
  float* ks = qs + kTile * LD;    // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* ps = vs + kTile * LD;    // [64][kPS], p of the current key tile

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;

  load_tile<D>(q + base, q0, seq, qs, scale);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k + base, k0, seq, ks, 1.f);
    load_tile<D>(v + base, k0, seq, vs, 1.f);
    __syncthreads();

    float s[4][4];
    dot_abt<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= seq) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max(tmax));  // finite: k0 < seq
      const float alpha = expf(m[i] - mnew);           // 0 on the first tile
      m[i] = mnew;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    acc_pv<D>(ps, vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float total = row_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    l[i] = 1.f / total;
    if (tx == 0 && row < seq)
      lse[static_cast<long long>(blockIdx.y) * seq + row] = m[i] + logf(total);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] *= l[i];
  store_rows<D>(o + base, q0, seq, ty, tx, acc, 1.f);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels, bf16 only (fragments, staging and the forward's body:
// attention_mma.cuh).
// ---------------------------------------------------------------------------

using tdt::bf16;
using tdt::kPad;

constexpr int kFwdWarps = 8;  // 128 query rows per block
template <int D>
constexpr int kFwdStages = D == 128 ? 2 : 4;  // slots of 64 keys

// Forward: one block per (128 query rows, bh) around
// `tdt::attention_fwd_block`, with a row stride of D.
template <int D>
__global__ void __launch_bounds__(kFwdWarps * 32, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;
  const long long base = rbase * D;
  tdt::attention_fwd_block<D, kFwdWarps, kFwdStages<D>>(
      q + base, k + base, v + base, D, o + base, D, lse + rbase,
      blockIdx.x * kFwdWarps * 16, seq, scale,
      reinterpret_cast<bf16*>(smem_raw));
}

// Backward on `mma.sync`, one pass (any T; d = 32 and 128, and d = 64 where
// the `wgmma` kernel below does not apply): one block of 8 warps per (128
// key rows, bh) walks the query tiles. Warp w owns key rows 16w .. 16w + 15 of the block: their K
// and V A fragments stay in registers (D <= 64), their dk and dv
// accumulate in registers. Per query tile (BM rows of q and g, with their
// lse and delta, in a ring of two slots filled by `cp.async`):
//   s^T = k . q^T and dp^T = v . g^T       (B fragments: `ldmatrix`)
//   p^T = 2^(s^T scale log2e - lse log2e), ds^T = p^T (dp^T - delta)
//   dv += p^T . g, dk += ds^T . q           (A: the accumulators, rounded to
//                                            bf16; B: `ldmatrix.trans`)
//   ds^T -> shared memory (bf16, [key][query]), barrier, then the block's
//   dq tile ds . k (BM x D over the 128 keys; A: `ldmatrix.trans` of ds^T,
//   B: `ldmatrix.trans` of K), split over the warps as BM / 16 row groups
//   by D / (8 / (BM / 16)) columns, added to the fp32 dq accumulator in
//   device memory with vector `red.global.add`.
// Two barriers per query tile: one after the wait for the tile's copies
// (which also frees ds^T), one after ds^T is written (which also frees the
// tile's slot: the next-but-one tile's copies start right after it and run
// under the dq product and the whole next tile). Keys and query rows past
// seq are zero-filled and their p forced to 0, on edge tiles only.
template <int D>
struct Bwd {
  static constexpr int BN = 128;                 // key rows per block
  static constexpr int BM = D == 128 ? 32 : 64;  // query rows per tile
  static constexpr int WARPS = BN / 16, THREADS = 32 * WARPS;
  static constexpr int STAGES = 2;
  static constexpr int LD = D + kPad;    // row stride of q, g, k, v tiles
  static constexpr int LDS = BM + kPad;  // row stride of ds^T
  static constexpr int MW = BM / 16;     // dq: warps along the query rows
  static constexpr int DQ_COLS = D / (WARPS / MW);  // dq columns per warp
  static constexpr bool kCache = D <= 64;  // K, V fragments in registers
  static constexpr size_t smem_bytes =
      (2 * BN * LD + 2 * STAGES * BM * LD + BN * LDS) * sizeof(bf16) +
      2 * STAGES * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(Bwd<D>::THREADS, 1)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g_in,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int seq, float scale) {
  using B = Bwd<D>;
  constexpr int BN = B::BN, BM = B::BM, LD = B::LD, LDS = B::LDS;
  constexpr int KK = D / 16, STAGES = B::STAGES, THREADS = B::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BN][LD]
  bf16* vs = ks + BN * LD;                       // [BN][LD]
  bf16* qs = vs + BN * LD;                       // [STAGES][BM][LD]
  bf16* gs = qs + STAGES * BM * LD;              // [STAGES][BM][LD]
  bf16* dst = gs + STAGES * BM * LD;             // [BN][LDS], ds^T
  float* lses = reinterpret_cast<float*>(dst + BN * LDS);  // [STAGES][BM]
  float* deltas = lses + STAGES * BM;                      // [STAGES][BM]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4, w16 = warp * 16;
  const int k0 = blockIdx.x * BN;
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;
  const long long base = rbase * D;
  const int nq = (seq + BM - 1) / BM;
  const float scale_log2 = scale * tdt::kLog2e;

  auto stage_tile = [&](int i) {
    const int slot = i % STAGES, q0 = i * BM;
    tdt::stage_async<D, BM, THREADS>(q + base, D, q0, seq,
                                     qs + slot * BM * LD);
    tdt::stage_async<D, BM, THREADS>(g_in + base, D, q0, seq,
                                     gs + slot * BM * LD);
    if (threadIdx.x < BM) {
      const int row = q0 + threadIdx.x;
      const bool valid = row < seq;
      const long long at = rbase + (valid ? row : 0);
      tdt::cp_async4(lses + slot * BM + threadIdx.x, lse + at, valid);
      tdt::cp_async4(deltas + slot * BM + threadIdx.x, delta + at, valid);
    }
  };
  tdt::stage_async<D, BN, THREADS>(k + base, D, k0, seq, ks);
  tdt::stage_async<D, BN, THREADS>(v + base, D, k0, seq, vs);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nq) stage_tile(s);
    tdt::cp_async_commit();  // group s: tile s (and k, v in group 0)
  }

  uint32_t ka[KK][4], va[KK][4];
  if constexpr (B::kCache) {
    tdt::cp_async_wait<STAGES - 1>();  // group 0 (k, v) has landed
    __syncthreads();
    tdt::load_a<KK, LD>(ks + w16 * LD, lane, ka);
    tdt::load_a<KK, LD>(vs + w16 * LD, lane, va);
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  tdt::zero(dk_acc);
  tdt::zero(dv_acc);
  const int qm = warp % B::MW, dn = warp / B::MW;  // this warp's dq part
  const int dq_a = (lane % 8 + lane / 16 * 8) * LDS + qm * 16 +
                   lane / 8 % 2 * 8;
  const bf16* dq_b = ks + (lane % 16) * LD + dn * B::DQ_COLS + lane / 16 * 8;

  // The block's share of tile i's dq: rows qm * 16 .., columns dn * DQ_COLS
  // .. of ds . k over the block's keys, added to the accumulator.
  auto dq_part = [&](int i) {
    float dqa[B::DQ_COLS / 8][4];
    tdt::zero(dqa);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      tdt::ldmatrix_x4_trans(a, dst + dq_a + kk * 16 * LDS);
#pragma unroll
      for (int j = 0; j < B::DQ_COLS / 16; ++j) {
        uint32_t f[4];
        tdt::ldmatrix_x4_trans(f, dq_b + kk * 16 * LD + j * 16);
        tdt::mma_bf16(dqa[2 * j], a, f[0], f[1]);
        tdt::mma_bf16(dqa[2 * j + 1], a, f[2], f[3]);
      }
    }
    const int row0 = i * BM + qm * 16 + g;
    float* out = dq_acc + (rbase + row0) * D + dn * B::DQ_COLS + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + 8 * h >= seq) continue;
#pragma unroll
      for (int t = 0; t < B::DQ_COLS / 8; ++t)
        atomicAdd(reinterpret_cast<float2*>(out + 8 * h * D + t * 8),
                  make_float2(dqa[t][2 * h], dqa[t][2 * h + 1]));
    }
  };

  for (int i = 0; i < nq; ++i) {
    tdt::cp_async_wait<STAGES - 1>();  // groups 0 .. i have landed
    __syncthreads();  // and every warp is done with ds^T of tile i - 1
    const int slot = i % STAGES, q0 = i * BM;
    const bf16* qt = qs + slot * BM * LD;
    const bf16* gt = gs + slot * BM * LD;
    const float* ls = lses + slot * BM;
    const float* dl = deltas + slot * BM;

    float st[BM / 8][4], dpt[BM / 8][4];  // key rows, query columns
    tdt::zero(st);
    tdt::zero(dpt);
    if constexpr (B::kCache) {
      tdt::mma_a_bt<KK, BM / 8, LD>(ka, qt, lane, st);
      tdt::mma_a_bt<KK, BM / 8, LD>(va, gt, lane, dpt);
    } else {
      tdt::load_a<KK, LD>(ks + w16 * LD, lane, ka);
      tdt::mma_a_bt<KK, BM / 8, LD>(ka, qt, lane, st);
      tdt::load_a<KK, LD>(vs + w16 * LD, lane, ka);
      tdt::mma_a_bt<KK, BM / 8, LD>(ka, gt, lane, dpt);
    }

    const bool edge = q0 + BM > seq || k0 + BN > seq;
#pragma unroll
    for (int t = 0; t < BM / 8; ++t) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + t * 8 + 2 * c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + t * 8 + 2 * c);
      const float nl[2] = {-l2.x * tdt::kLog2e, -l2.y * tdt::kLog2e};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tdt::fast_exp2(fmaf(st[t][e], scale_log2, nl[e % 2]));
        if (edge && (q0 + t * 8 + 2 * c + e % 2 >= seq ||
                     k0 + w16 + g + 8 * (e / 2) >= seq))
          p = 0.f;
        st[t][e] = p;                               // p^T
        dpt[t][e] = p * (dpt[t][e] - dd[e % 2]);    // ds^T
      }
    }
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
    tdt::pack_a<BM / 16>(st, pa);
    tdt::pack_a<BM / 16>(dpt, dsa);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      bf16* row = dst + (w16 + g) * LDS + kk * 16 + 2 * c;
      *reinterpret_cast<uint32_t*>(row) = dsa[kk][0];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS) = dsa[kk][1];
      *reinterpret_cast<uint32_t*>(row + 8) = dsa[kk][2];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS + 8) = dsa[kk][3];
    }
    tdt::mma_a_b<BM / 16, D / 8, LD>(pa, gt, lane, dv_acc);   // dv += p^T . g
    tdt::mma_a_b<BM / 16, D / 8, LD>(dsa, qt, lane, dk_acc);  // dk += ds^T . q
    __syncthreads();  // ds^T is written; the tile's slot is consumed
    if (i + STAGES < nq) stage_tile(i + STAGES);
    tdt::cp_async_commit();
    dq_part(i);
  }
  __syncthreads();  // every warp is done reading K for its dq part
  // each warp's own 16 rows of ks and vs serve as its output staging
  tdt::store_rows16<D>(dk_acc, scale, scale, ks + w16 * LD, dk + base, D,
                       k0 + w16, seq, lane);
  tdt::store_rows16<D>(dv_acc, 1.f, 1.f, vs + w16 * LD, dv + base, D,
                       k0 + w16, seq, lane);
}

// dq = bf16(scale * the fp32 accumulator), 8 elements per thread.
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const float* __restrict__ dq_acc,
                            bf16* __restrict__ dq, long long n8, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * i + 1];
  uint4 out;
  out.x = tdt::pack_bf16(a.x * scale, a.y * scale);
  out.y = tdt::pack_bf16(a.z * scale, a.w * scale);
  out.z = tdt::pack_bf16(b.x * scale, b.y * scale);
  out.w = tdt::pack_bf16(b.z * scale, b.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = out;
}

// ---------------------------------------------------------------------------
// Backward for D = 64 and T a multiple of 128 on `wgmma`, TMA and mbarriers
// (`flash_bwd_tma_kernel`): the same one-pass block (128 key rows, two
// warpgroups of 64) with every product run as `wgmma.mma_async`: A (this
// warpgroup's K, V rows; p^T, ds^T) from registers, B (the q and g tiles)
// read by the tensor cores from shared memory once per 64 rows instead of
// once per 16. Tiles are [rows][64] bf16, 128-byte rows in 1024-byte aligned
// groups of 8 with the 128-byte swizzle (16-byte chunk index xor row % 8),
// which TMA writes directly and which serves `wgmma` (K-major for the
// products over d, MN-major for those over the tile's rows) and `ldmatrix`
// without bank conflicts alike.
// ---------------------------------------------------------------------------

// The Hopper helpers of hopper.cuh.
using tdt::bulk_load;
using tdt::EncodeTiled;
using tdt::encode_tiled;
using tdt::fence_async_smem;
using tdt::fence_regs;
using tdt::kW;
using tdt::mbar_arrive;
using tdt::mbar_expect_tx;
using tdt::mbar_init;
using tdt::mbar_wait;
using tdt::regs_alloc;
using tdt::regs_dealloc;
using tdt::swz;
using tdt::tma_load_tile;
using tdt::warpgroup_sync;
using tdt::wgmma_commit;
using tdt::wgmma_desc;
using tdt::wgmma_fence;
using tdt::wgmma_m64n128k16_ss;
using tdt::wgmma_m64n64k16;
using tdt::wgmma_wait;

// d (64 x 32 over the warpgroup; this warp's 16 rows as 4 accumulator
// tiles) = A . B (+ d if accumulate), both from shared memory: A as [k][m]
// (m contiguous, transposed), B as [n][k] (k contiguous).
__device__ __forceinline__ void wgmma_m64n32k16_at_b(float (&d)[4][4],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15},"
      " %16,"
      " %17,"
      " p,   1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

struct BwdT {
  static constexpr int D = 64, BN = 128, BM = 64, THREADS = 256;
  static constexpr int SLOTS = 4;
  static constexpr int TILE = 64 * kW;  // elements of a 64-row tile
  // k, v (later the fp32 dq tiles), k^T, the q and g slots, ds^T twice, lse
  // and delta, 13 barriers; 1024 bytes of slack to align the tiles
  static constexpr size_t smem_bytes =
      (4 * TILE + 2 * TILE + 2 * SLOTS * TILE + 4 * TILE) * sizeof(bf16) +
      2 * SLOTS * BM * sizeof(float) + 16 * sizeof(uint64_t) + 1024;
};

// The tiles arrive by TMA: thread 0 asks for query tile i + 2 (q, g, lse,
// delta: 16.9 KB into one of four slots) at the top of tile i, an mbarrier
// per slot tells when it has landed, another when both warpgroups have
// consumed it. No block barrier in the loop: the warpgroups meet only
// through mbarriers (slot free, ds^T written, ds^T read), so that one can
// run its exponentials while the other's products occupy the tensor cores.
// Per tile and warpgroup: s^T and dp^T (each 4 `wgmma` m64n64k16, B
// K-major) and the dq product of tile i - 1 are started together; p^T comes
// from s^T while dp^T still runs; ds^T goes to shared memory (one of two
// buffers) for the dq product of the next tile; dv += p^T . g and dk +=
// ds^T . q (B MN-major) are started and stay in flight into tile i + 1.
// dq = ds . k over the block's 128 keys runs as 8 m64n32k16 per warpgroup
// (its 32 columns): A = ds^T read transposed from shared memory, B = K
// transposed once per block ([d][key], K-major). Each warpgroup writes its
// 64 x 32 fp32 dq tile to shared memory in the order its threads hold it
// (no bank conflicts) and adds it to the accumulator in device memory with
// one 8 KB bulk reduce (`cp.reduce.async.bulk ... add.f32`), so the
// accumulator is kept in that order too and `flash_bwd_dq_gather_kernel`
// undoes it. T is a multiple of the tile sizes, so nothing is masked.
__global__ void __launch_bounds__(BwdT::THREADS, 1)
flash_bwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int seq, float scale) {
  using B = BwdT;
  constexpr int D = B::D, BN = B::BN, BM = B::BM, SLOTS = B::SLOTS;
  constexpr int TILE = B::TILE, KK = D / 16;
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* vs = ks + 2 * TILE;           // [BN][64]
  bf16* kt = vs + 2 * TILE;           // [2][64 d][64 keys], K transposed
  bf16* qs = kt + 2 * TILE;           // [SLOTS][BM][64]
  bf16* gs = qs + SLOTS * TILE;       // [SLOTS][BM][64]
  bf16* dst = gs + SLOTS * TILE;      // [2][BN][64], ds^T
  float* lses = reinterpret_cast<float*>(dst + 4 * TILE);  // [SLOTS][BM]
  float* deltas = lses + SLOTS * BM;                       // [SLOTS][BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(deltas + SLOTS * BM);
  uint64_t* empty = full + SLOTS;     // [SLOTS]
  uint64_t* ds_ready = empty + SLOTS; // [2]
  uint64_t* ds_free = ds_ready + 2;   // [2]
  uint64_t* kv_full = ds_free + 2;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, wt = threadIdx.x % 128;
  const int g = lane / 4, c = lane % 4, w16 = warp * 16;
  const int k0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * seq;  // the slice's first row in [BH * T]
  const long long base = static_cast<long long>(row0) * D;
  const int nq = seq / BM;
  const float scale_log2 = scale * tdt::kLog2e;
  // this warpgroup's two dq tiles [2][4][128] float4, over k and v's place
  float* dqs = reinterpret_cast<float*>(ks) + wg * 2 * (BM * 32);
  float* dq_tiles = dq_acc + (static_cast<long long>(blockIdx.y) * nq * 2 +
                              wg) * (BM * 32);
  const bool producer = threadIdx.x == 0, leader = wt == 0;

  if (producer) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(ds_ready + b, 2);
      mbar_init(ds_free + b, 2);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int i) {  // the producer asks for query tile i
    const int slot = i % SLOTS;
    mbar_expect_tx(full + slot, 2 * TILE * 2 + 2 * BM * 4);
    tma_load_tile(qs + slot * TILE, &q_map, row0 + i * BM, full + slot);
    tma_load_tile(gs + slot * TILE, &g_map, row0 + i * BM, full + slot);
    bulk_load(lses + slot * BM, lse + row0 + i * BM, BM * 4, full + slot);
    bulk_load(deltas + slot * BM, delta + row0 + i * BM, BM * 4, full + slot);
  };
  if (producer) {
    mbar_expect_tx(kv_full, 4 * TILE * 2);
    tma_load_tile(ks, &k_map, row0 + k0, kv_full);
    tma_load_tile(ks + TILE, &k_map, row0 + k0 + 64, kv_full);
    tma_load_tile(vs, &v_map, row0 + k0, kv_full);
    tma_load_tile(vs + TILE, &v_map, row0 + k0 + 64, kv_full);
    load_tile(0);
    if (nq > 1) load_tile(1);
  }

  // this warp's 16 K and V rows as A fragments, for the whole kernel, and
  // K transposed for the dq product: kt[key / 64][d][key % 64]
  uint32_t ka[KK][4], va[KK][4];
  mbar_wait(kv_full, 0);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const bf16* at = ks + swz(w16 + lane % 16, kk * 16 + lane / 16 * 8);
    tdt::ldmatrix_x4(ka[kk], at);
    tdt::ldmatrix_x4(va[kk], vs + (at - ks));
    uint32_t t[4];  // matrix m: keys (m % 2) * 8 + 2c, + 1 at d + (m / 2) * 8
    tdt::ldmatrix_x4_trans(t, at);
    bf16* panel = kt + wg * TILE;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<uint32_t*>(
          panel + swz(kk * 16 + m / 2 * 8 + g,
                      warp % 4 * 16 + m % 2 * 8 + 2 * c)) = t[m];
  }
  fence_async_smem();  // k^T is a `wgmma` operand
  __syncthreads();     // k^T is whole; k and v's place is free for dq tiles
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  tdt::zero(dk_acc);
  tdt::zero(dv_acc);
  const uint64_t kt_desc = wgmma_desc(kt + wg * 32 * kW);
  auto start_dq = [&](int i, float (&dqa)[4][4]) {
    const uint64_t ds_desc = wgmma_desc(dst + i % 2 * 2 * TILE);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n32k16_at_b(dqa, ds_desc + 128 * kk,
                           kt_desc + 512 * (kk / 4) + 2 * (kk % 4), kk > 0);
  };
  auto write_dq = [&](int i, const float (&dqa)[4][4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      reinterpret_cast<float4*>(dqs + i % 2 * (BM * 32))[t * 128 + wt] =
          make_float4(dqa[t][0], dqa[t][1], dqa[t][2], dqa[t][3]);
    fence_async_smem();  // the bulk reduce reads through the async proxy
  };
  auto reduce_dq = [&](int i) {  // the leader adds the warpgroup's dq tile
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(dq_tiles +
                                  static_cast<long long>(i) * 2 * (BM * 32)),
        "r"(tdt::smem_addr(dqs + i % 2 * (BM * 32))), "r"(BM * 32 * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  for (int i = 0; i < nq; ++i) {
    if (producer && i + 2 < nq) {
      // the slot of tile i - 2: free once both warpgroups' dv, dk are done
      if (i >= 2) mbar_wait(empty + (i + 2) % SLOTS, ((i + 2) / SLOTS - 1) & 1);
      load_tile(i + 2);
    }
    const int slot = i % SLOTS;
    const float* ls = lses + slot * BM;
    const float* dl = deltas + slot * BM;
    const uint64_t q_desc = wgmma_desc(qs + slot * TILE);
    const uint64_t g_desc = wgmma_desc(gs + slot * TILE);
    bf16* ds = dst + i % 2 * 2 * TILE;
    mbar_wait(full + slot, i / SLOTS & 1);

    float st[BM / 8][4], dpt[BM / 8][4], dqa[4][4];
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_m64n64k16<0>(st, ka[kk], q_desc + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_m64n64k16<0>(dpt, va[kk], g_desc + 2 * kk, kk > 0);
    wgmma_commit();
    if (i >= 1) {
      mbar_wait(ds_ready + (i - 1) % 2, (i - 1) / 2 & 1);
      start_dq(i - 1, dqa);
    }
    wgmma_commit();  // (empty for the first tile)
    wgmma_wait<2>();  // s^T, and dv, dk of tile i - 1
    fence_regs(st);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (leader && i >= 1) mbar_arrive(empty + (i - 1) % SLOTS);

#pragma unroll
    for (int t = 0; t < BM / 8; ++t) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + t * 8 + 2 * c);
      const float nl[2] = {-l2.x * tdt::kLog2e, -l2.y * tdt::kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[t][e] = tdt::fast_exp2(fmaf(st[t][e], scale_log2, nl[e % 2]));
    }
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
    tdt::pack_a<BM / 16>(st, pa);
    wgmma_wait<1>();  // dp^T
    fence_regs(dpt);
#pragma unroll
    for (int t = 0; t < BM / 8; ++t) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + t * 8 + 2 * c);
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[t][e] = st[t][e] * (dpt[t][e] - dd[e % 2]);  // ds^T
    }
    tdt::pack_a<BM / 16>(dpt, dsa);
    // ds^T of tile i - 2 has been read by both warpgroups' dq products
    if (i >= 2) mbar_wait(ds_free + i % 2, (i / 2 - 1) & 1);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const int r = w16 + g, col = kk * 16 + 2 * c;
      *reinterpret_cast<uint32_t*>(ds + swz(r, col)) = dsa[kk][0];
      *reinterpret_cast<uint32_t*>(ds + swz(r + 8, col)) = dsa[kk][1];
      *reinterpret_cast<uint32_t*>(ds + swz(r, col + 8)) = dsa[kk][2];
      *reinterpret_cast<uint32_t*>(ds + swz(r + 8, col + 8)) = dsa[kk][3];
    }
    fence_async_smem();  // ds^T is a `wgmma` operand of the dq product
    // the dq tile written below is free once its last reduce has read it
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(wg);  // the warpgroup's ds^T and last dq tile are written
    if (leader) {
      mbar_arrive(ds_ready + i % 2);
      if (i >= 2) reduce_dq(i - 2);
    }
    wgmma_wait<0>();  // dq of tile i - 1
    fence_regs(dqa);
    if (i >= 1) {
      if (leader) mbar_arrive(ds_free + (i - 1) % 2);
      write_dq(i - 1, dqa);
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_m64n64k16<1>(dv_acc, pa[kk], g_desc + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_m64n64k16<1>(dk_acc, dsa[kk], q_desc + 128 * kk, 1);
    wgmma_commit();  // awaited in the next tile
  }
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  warpgroup_sync(wg);
  if (leader && nq >= 2) reduce_dq(nq - 2);
  {
    float dqa[4][4];
    mbar_wait(ds_ready + (nq - 1) % 2, (nq - 1) / 2 & 1);
    fence_regs(dqa);
    wgmma_fence();
    start_dq(nq - 1, dqa);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    write_dq(nq - 1, dqa);
  }
  warpgroup_sync(wg);
  if (leader) {
    reduce_dq(nq - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();  // both warpgroups are done with the slots
  bf16* stg = qs + warp * 16 * (D + kPad);
  tdt::store_rows16<D>(dk_acc, scale, scale, stg, dk + base, D, k0 + w16, seq,
                       lane);
  tdt::store_rows16<D>(dv_acc, 1.f, 1.f, stg, dv + base, D, k0 + w16, seq,
                       lane);
}

// dq = bf16(scale * the TMA kernel's fp32 accumulator), which holds per (bh,
// query tile of 64 rows, warpgroup w) 2048 floats in the order the
// warpgroup's threads hold its 64 x 32 dq accumulator: float4 number
// j * 128 + t is thread t's tile j: rows 16 * (t / 32) + g and + 8, columns
// 32 * w + 8 * j + 2 * c and + 1 (g = t % 32 / 4, c = t % 4).
__global__ void __launch_bounds__(512)
flash_bwd_dq_gather_kernel(const float* __restrict__ dq_acc,
                           bf16* __restrict__ dq, int seq, float scale) {
  const int r = threadIdx.x / 8, j8 = threadIdx.x % 8;
  const int nq = seq / 64;
  const int row = blockIdx.x * 64 + r;
  if (row >= seq) return;
  const float* tile = dq_acc + ((static_cast<long long>(blockIdx.y) * nq +
                                 blockIdx.x) * 2 + j8 / 4) * 2048;
  const int g = r % 8, h = r % 16 / 8, j = j8 % 4;
  uint32_t out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 x = *reinterpret_cast<const float2*>(
        tile + (j * 128 + r / 16 * 32 + 4 * g + c) * 4 + 2 * h);
    out[c] = tdt::pack_bf16(x.x * scale, x.y * scale);
  }
  *reinterpret_cast<uint4*>(
      dq + (static_cast<long long>(blockIdx.y) * seq + row) * 64 + j8 * 8) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// ---------------------------------------------------------------------------
// Forward for D = 64 and T a multiple of 128 on `wgmma`, TMA and mbarriers
// (`flash_fwd_tma_kernel`; replaces `_flash_attention_3d` /
// `_attn_fwd_kernel` of tpu_diffusion/kernels/attention.py at the UNet's
// shape), after FlashAttention-3. One persistent block per SM walks the
// (128 query rows, bh) items with three warpgroups. The third is the
// producer: it gives its registers to the others (`setmaxnreg`) and one of
// its threads asks TMA for each item's q tile (two buffers, so the next
// item's q lands while this one runs) and for each 128-key tile's K and V,
// into a ring of STAGES slots that runs on across items; an mbarrier per
// slot and operand says when a tile has landed, another when both
// consumers are done with it. The two consumer warpgroups own 64 query
// rows each and meet nothing but those mbarriers and two named barriers:
// there is no block barrier after the set-up. Per key tile j a consumer
// issues s_j = q . k_j^T (4 `wgmma` m64n128k16, q and K from the swizzled
// tiles, K-major both) and o += p_{j-1} . v_{j-1} (8 `wgmma` m64n64k16, p in
// registers, V MN-major from its tile), then runs tile j's online softmax
// (base 2, scale and log2(e) folded into one multiply-add per logit,
// `ex2.approx`) while p_{j-1} . v_{j-1} is still in the tensor cores; only
// the rescaling of o waits for it. The two warpgroups take turns at issuing
// (ping-pong), so that one's exponentials run under the other's products.
// o leaves through the warpgroup's own q rows (swizzled, no bank conflicts)
// as 16-byte stores. Measured alternatives (PERF.md): no turns, q as a
// register operand, one block per item: each slower.
// Traps: an item's o staging writes the q buffer with `st.shared` that the
// next TMA load overwrites: `fence.proxy.async` before the buffer is given
// back; `setmaxnreg` needs the producer and consumer paths to part once
// and never meet again (no `__syncthreads` after the split); the named
// barriers' ids must differ from those of `bar.sync` elsewhere in the
// block (0 is `__syncthreads`); a warpgroup's last turn is not passed, or
// a barrier would be left with an arrival that no one waits for.
// ---------------------------------------------------------------------------

struct FwdT {
  static constexpr int BM = 128, BN = 128, STAGES = 3;  // d = 64
  static constexpr int THREADS = 384;  // two consumer warpgroups, a producer
  static constexpr int TILE = BN * kW;  // elements of a 128-row tile
  // two q buffers, the K and V slots, 16 barriers; 1024 bytes of slack to
  // align the tiles
  static constexpr size_t smem_bytes =
      (2 * BM * kW + 2 * STAGES * TILE) * sizeof(bf16) +
      16 * sizeof(uint64_t) + 1024;
};

// Named barriers 1 and 2 make the two consumer warpgroups take turns at
// issuing their products: warpgroup w waits on barrier 1 + w, issues, and
// lets the other one go, so that one's exponentials run while the other's
// products occupy the tensor cores. Barriers 3 and 4 are each warpgroup's
// own.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__global__ void __launch_bounds__(FwdT::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ o, float* __restrict__ lse, int seq,
                     int items, float scale) {
  using F = FwdT;
  constexpr int BM = F::BM, BN = F::BN, STAGES = F::STAGES, TILE = F::TILE;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = qs + 2 * BM * kW;      // [STAGES][BN][64]
  bf16* vs = ks + STAGES * TILE;    // [STAGES][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);  // [2]
  uint64_t* q_empty = q_full + 2;      // [2]
  uint64_t* k_full = q_empty + 2;      // [STAGES]
  uint64_t* v_full = k_full + STAGES;  // [STAGES]
  uint64_t* empty = v_full + STAGES;   // [STAGES]

  const int wg = threadIdx.x / 128;
  const int nq = seq / BM, nk = seq / BN;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + b, 1);
      mbar_init(q_empty + b, 2);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      // q of item number `it` (this block's it-th) into buffer it % 2, once
      // both warpgroups are done with the buffer's item it - 2
      auto load_q = [&](int it) {
        const int item = blockIdx.x + it * gridDim.x, qb = it % 2;
        const int r = item / nq * seq + item % nq * BM;
        if (it >= 2) mbar_wait(q_empty + qb, (it / 2 - 1) & 1);
        mbar_expect_tx(q_full + qb, BM * kW * 2);
        tma_load_tile(qs + qb * BM * kW, &q_map, r, q_full + qb);
        tma_load_tile(qs + qb * BM * kW + 64 * kW, &q_map, r + 64,
                      q_full + qb);
      };
      load_q(0);
      int jj = 0;  // key tiles requested so far, over all items
      for (int it = 0, item = blockIdx.x; item < items;
           ++it, item += gridDim.x) {
        const int row0 = item / nq * seq;
        for (int j = 0; j < nk; ++j, ++jj) {
          const int slot = jj % STAGES, r = row0 + j * BN;
          // the slot's last tile, jj - STAGES, is done in both warpgroups
          if (jj >= STAGES) mbar_wait(empty + slot, (jj / STAGES - 1) & 1);
          mbar_expect_tx(k_full + slot, TILE * 2);
          tma_load_tile(ks + slot * TILE, &k_map, r, k_full + slot);
          tma_load_tile(ks + slot * TILE + 64 * kW, &k_map, r + 64,
                        k_full + slot);
          mbar_expect_tx(v_full + slot, TILE * 2);
          tma_load_tile(vs + slot * TILE, &v_map, r, v_full + slot);
          tma_load_tile(vs + slot * TILE + 64 * kW, &v_map, r + 64,
                        v_full + slot);
          // the next item's q, once this item's first tiles are on their
          // way: it waits for the buffer's last item to be stored, and then
          // lands during this item
          if (j == (nk < STAGES ? nk : STAGES) - 1 && item + gridDim.x < items)
            load_q(it + 1);
        }
      }
    }
    return;
  }

  regs_alloc<240>();
  const int lane = threadIdx.x % 32, wt = threadIdx.x % 128;
  const int w16 = (wt / 32) * 16;  // this warp's first row in its 64
  const int g = lane / 4, c = lane % 4;
  const float scale_log2 = scale * tdt::kLog2e;
  float s[BN / 8][4], acc[8][4];
  uint32_t pa[BN / 16][4];
  float m[2], l[2];  // running max of the scaled logits; this thread's
                     // share of the two row sums
  int jj = 0;        // key tiles consumed so far, over all items

  auto issue_qk = [&](uint64_t q_desc, int jt) {  // s = q . k^T, tile jt
    const int slot = jt % STAGES;
    const uint64_t k_desc = wgmma_desc(ks + slot * TILE);
    mbar_wait(k_full + slot, jt / STAGES & 1);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int jt) {  // acc += p . v, tile jt
    const int slot = jt % STAGES;
    const uint64_t v_desc = wgmma_desc(vs + slot * TILE);
    mbar_wait(v_full + slot, jt / STAGES & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n64k16<1>(acc, pa[kk], v_desc + 128 * kk, 1);
    wgmma_commit();
  };
  // s -> the unnormalised p of this tile in place; returns the factor by
  // which the earlier tiles' o and l shrink (rows g and g + 8). The maxima
  // and sums run as four independent chains per row.
  auto softmax = [&](float (&alpha)[2]) {
    float mx[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        mx[h][u] = fmaxf(s[u][2 * h], s[u][2 * h + 1]);
#pragma unroll
    for (int t = 4; t < BN / 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h][t % 4] =
            fmaxf(mx[h][t % 4], fmaxf(s[t][2 * h], s[t][2 * h + 1]));
    float mnew[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      mnew[h] = fmaxf(m[h], tmax * scale_log2);
      alpha[h] = tdt::fast_exp2(m[h] - mnew[h]);  // 0 on the first tile
      m[h] = mnew[h];
    }
    float ps[2][4] = {};
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[t][e];
        x = tdt::fast_exp2(fmaf(x, scale_log2, -mnew[e / 2]));
        ps[e / 2][t % 4] += x;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * alpha[h] + ((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]));
  };

  if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
  for (int it = 0, item = blockIdx.x; item < items;
       ++it, item += gridDim.x) {
    const int row0 = item / nq * seq, q0 = item % nq * BM;
    const int qb = it % 2;
    bf16* qw = qs + qb * BM * kW + wg * 64 * kW;  // this warpgroup's rows
    const uint64_t q_desc = wgmma_desc(qw);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    tdt::zero(acc);
    float alpha[2];
    mbar_wait(q_full + qb, it / 2 & 1);
    turn_wait(wg);
    issue_qk(q_desc, jj);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(alpha);
    tdt::pack_a<BN / 16>(s, pa);
    for (int j = 1; j < nk; ++j) {
      turn_wait(wg);
      issue_qk(q_desc, jj + j);
      issue_pv(jj + j - 1);
      turn_pass(wg);
      wgmma_wait<1>();  // s_j; p_{j-1} . v_{j-1} may still run
      fence_regs(s);
      softmax(alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      if (wt == 0) mbar_arrive(empty + (jj + j - 1) % STAGES);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] *= alpha[0];
        acc[t][1] *= alpha[0];
        acc[t][2] *= alpha[1];
        acc[t][3] *= alpha[1];
      }
      tdt::pack_a<BN / 16>(s, pa);
    }
    turn_wait(wg);
    issue_pv(jj + nk - 1);
    // warpgroup 1's very last pass would have no wait to meet
    if (wg == 0 || item + gridDim.x < items) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);
    if (wt == 0) mbar_arrive(empty + (jj + nk - 1) % STAGES);
    jj += nk;

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float total = l[h];
      total += __shfl_xor_sync(0xffffffffu, total, 1);
      total += __shfl_xor_sync(0xffffffffu, total, 2);
      inv[h] = 1.f / total;
      if (c == 0)
        lse[row0 + q0 + wg * 64 + w16 + g + 8 * h] =
            m[h] * tdt::kLn2 + logf(total);
    }
    // o as bf16 into the warp's own 16 rows of its q tile (every `wgmma`
    // that read them has completed), then 16-byte stores of whole rows
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      *reinterpret_cast<uint32_t*>(qw + swz(w16 + g, t * 8 + 2 * c)) =
          tdt::pack_bf16(acc[t][0] * inv[0], acc[t][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(qw + swz(w16 + g + 8, t * 8 + 2 * c)) =
          tdt::pack_bf16(acc[t][2] * inv[1], acc[t][3] * inv[1]);
    }
    __syncwarp();
    bf16* out = o + static_cast<long long>(row0 + q0 + wg * 64 + w16) * 64;
#pragma unroll
    for (int idx = lane; idx < 16 * 8; idx += 32) {
      const int r = idx / 8, ch = idx % 8;
      *reinterpret_cast<uint4*>(out + r * 64 + ch * 8) =
          *reinterpret_cast<const uint4*>(qw + swz(w16 + r, ch * 8));
    }
    // the q buffer is free (for the next TMA write) once the warpgroup's
    // four warps have read their rows of it
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    if (wt == 0) mbar_arrive(q_empty + qb);
  }
}

// A map of a [rows][64] bf16 matrix in boxes of 64 x 64 with the 128-byte
// swizzle.
cudaError_t tile_map(const void* ptr, long long rows, CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {64, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, 64}, elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Scalar backward, fp32 only, dq: one block per (64-row query tile, bh),
// looping over keys.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int seq, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][LD], q * scale
  float* gs = qs + kTile * LD;    // [64][LD]
  float* ks = gs + kTile * LD;    // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* dss = vs + kTile * LD;   // [64][kPS], ds of the current key tile

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;

  load_tile<D>(q + base, q0, seq, qs, scale);
  load_tile<D>(g + base, q0, seq, gs, 1.f);
  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < seq ? lse[rbase + row] : 0.f;
    row_delta[i] = row < seq ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<D>(k + base, k0, seq, ks, 1.f);
    load_tile<D>(v + base, k0, seq, vs, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_abt<D>(qs, ks, ty, tx, s);
    dot_abt<D>(gs, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + tx + 16 * j < seq;
        const float p = valid ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    acc_pv<D>(dss, ks, ty, tx, acc);
  }
  store_rows<D>(dq + base, q0, seq, ty, tx, acc, scale);
}

// ---------------------------------------------------------------------------
// Scalar backward, fp32 only, dk and dv: one block per (64-row key tile,
// bh), looping over queries.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int seq,
                      float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [64][LD]
  float* vs = ks + kTile * LD;    // [64][LD]
  float* qs = vs + kTile * LD;    // [64][LD], q * scale
  float* gs = qs + kTile * LD;    // [64][LD]
  float* pts = gs + kTile * LD;   // [64][kPS], p^T (key rows, query columns)
  float* dsts = pts + kTile * kPS;  // [64][kPS], ds^T
  float* lses = dsts + kTile * kPS;  // [64]
  float* deltas = lses + kTile;      // [64]

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;

  load_tile<D>(k + base, k0, seq, ks, 1.f);
  load_tile<D>(v + base, k0, seq, vs, 1.f);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(q + base, q0, seq, qs, scale);
    load_tile<D>(g + base, q0, seq, gs, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lses[threadIdx.x] = row < seq ? lse[rbase + row] : 0.f;
      deltas[threadIdx.x] = row < seq ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
    dot_abt<D>(ks, qs, ty, tx, st);   // (q . k)^T: key rows, query columns
    dot_abt<D>(vs, gs, ty, tx, dpt);  // (g . v)^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool valid = q0 + c < seq;
        const float p = valid ? expf(st[i][j] - lses[c]) : 0.f;
        pts[(ty + 16 * i) * kPS + c] = p;
        dsts[(ty + 16 * i) * kPS + c] = p * (dpt[i][j] - deltas[c]);
      }
    __syncthreads();
    acc_pv<D>(pts, gs, ty, tx, dv_acc);
    acc_pv<D>(dsts, qs, ty, tx, dk_acc);  // qs holds q * scale
  }
  store_rows<D>(dk + base, k0, seq, ty, tx, dk_acc, 1.f);
  store_rows<D>(dv + base, k0, seq, ty, tx, dv_acc, 1.f);
}

constexpr size_t tile_floats(int d) {
  return static_cast<size_t>(kTile) * (d + 1);
}

using tdt::allow_smem;

// ---------------------------------------------------------------------------
// Cross-attention forward (`flash_cross_attention`: the latent-diffusion
// UNet's attn2), bf16, D = 64: q [BH, Tq, D] against a short key set, k and
// v [BH, Tk, D] with Tk <= 128 (77 text tokens in Stable Diffusion).
// ---------------------------------------------------------------------------
//
// The whole key set is one tile: a block stages K and V of its bh once
// (`cp.async`, KT = Tk rounded up to 16 rows, the rows past Tk zero-filled),
// then its warps stream query rows, 16 a warp at a time, kXRows rows a
// block: q staged into the warp's own rows, s = q . k^T (`mma.sync`, KT / 8
// accumulator tiles), keys past Tk masked to -inf, one plain softmax in base
// 2 (no running max: one tile), the unnormalised p rounded to bf16 as the A
// fragments of p . v in registers, divided by the fp32 row sum at the end
// (the "mma" self-attention route's rounding), and the 16 x D output leaving
// through the same staging rows in 16-byte stores. No lse: no backward.
// Bound on the H100: bytes. At Tq = 4096, 5 heads and batch 8 a call reads
// and writes 42 MB of q and o against 0.10 GFLOP (4 Tq Tk D a slice), so
// what matters is that q streams once and o leaves once; K and V (20 KB a
// bh) are read again by each of the bh's blocks, from L2.
constexpr int kXWarps = 8;
constexpr int kXRows = 256;  // query rows per block

template <int D, int KT>
constexpr size_t xattn_smem_bytes() {
  return static_cast<size_t>(2 * KT + kXWarps * 16) * (D + kPad) *
         sizeof(bf16);
}

template <int D, int KT>
__global__ void __launch_bounds__(kXWarps * 32)
flash_xattn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int tq, int tk, float scale) {
  constexpr int LD = D + kPad, KK = D / 16, NT = KT / 8, VPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [KT][LD]
  bf16* vs = ks + KT * LD;                        // [KT][LD]
  bf16* mine = vs + KT * LD + (threadIdx.x / 32) * 16 * LD;  // [16][LD]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = lane % 4;
  const long long bh = blockIdx.y;
  const bf16* qb = q + bh * tq * D;
  bf16* ob = o + bh * tq * D;
  const float scale_log2 = scale * tdt::kLog2e;

  // this warp's 16 query rows from row0 into its staging rows
  auto stage_q = [&](int row0) {
    for (int idx = lane; idx < 16 * VPR; idx += 32) {
      const int r = idx / VPR, col = (idx % VPR) * 8;
      const bool valid = row0 + r < tq;
      tdt::cp_async16(mine + r * LD + col,
                      qb + static_cast<long long>(valid ? row0 + r : 0) * D +
                          col,
                      valid);
    }
  };
  tdt::stage_async<D, KT, kXWarps * 32>(k + bh * tk * D, D, 0, tk, ks);
  tdt::stage_async<D, KT, kXWarps * 32>(v + bh * tk * D, D, 0, tk, vs);
  const int first = static_cast<int>(blockIdx.x) * kXRows;
  const int end = min(tq, first + kXRows);
  int row0 = first + warp * 16;
  if (row0 < end) stage_q(row0);
  tdt::cp_async_commit();
  tdt::cp_async_wait<0>();
  __syncthreads();  // K, V and every warp's first rows have landed

  for (; row0 < end; row0 += kXWarps * 16) {
    uint32_t qa[KK][4];
    tdt::load_a<KK, LD>(mine, lane, qa);
    float s[NT][4];
    tdt::zero(s);
    tdt::mma_a_bt<KK, NT, LD>(qa, ks, lane, s);
    if (KT > tk) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * 8 + 2 * c + e % 2 >= tk) s[t][e] = -INFINITY;
    }
    float inv[2];
    // rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        m = fmaxf(m, fmaxf(s[t][2 * h], s[t][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m *= scale_log2;  // finite: key 0 is valid
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[t][2 * h + e];
          x = tdt::fast_exp2(fmaf(x, scale_log2, -m));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = 1.f / sum;
    }
    uint32_t pa[KT / 16][4];
    tdt::pack_a<KT / 16>(s, pa);
    float acc[D / 8][4];
    tdt::zero(acc);
    tdt::mma_a_b<KT / 16, D / 8, LD>(pa, vs, lane, acc);
    // q's rows were read into registers: the staging rows take the output
    tdt::store_rows16<D>(acc, inv[0], inv[1], mine, ob, D, row0, tq, lane);
    if (row0 + kXWarps * 16 < end) {
      __syncwarp();  // every lane has stored its share of the rows
      stage_q(row0 + kXWarps * 16);
      tdt::cp_async_commit();
      tdt::cp_async_wait<0>();
      __syncwarp();
    }
  }
}

template <int D, int KT>
cudaError_t launch_xattn_kt(const void* q, const void* k, const void* v,
                            void* o, int bh, int tq, int tk, float scale,
                            cudaStream_t stream) {
  constexpr size_t bytes = xattn_smem_bytes<D, KT>();
  const cudaError_t err = allow_smem<flash_xattn_fwd_kernel<D, KT>>(bytes);
  if (err != cudaSuccess) return err;
  flash_xattn_fwd_kernel<D, KT>
      <<<dim3((tq + kXRows - 1) / kXRows, bh), kXWarps * 32, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), tq, tk, scale);
  return cudaGetLastError();
}

cudaError_t launch_xattn(const void* q, const void* k, const void* v, void* o,
                         int bh, int tq, int tk, float scale,
                         cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || tq < 1 || tk < 1) return cudaErrorInvalidValue;
  switch ((tk + 15) / 16) {
    case 1: return launch_xattn_kt<64, 16>(q, k, v, o, bh, tq, tk, scale, stream);
    case 2: return launch_xattn_kt<64, 32>(q, k, v, o, bh, tq, tk, scale, stream);
    case 3: return launch_xattn_kt<64, 48>(q, k, v, o, bh, tq, tk, scale, stream);
    case 4: return launch_xattn_kt<64, 64>(q, k, v, o, bh, tq, tk, scale, stream);
    case 5: return launch_xattn_kt<64, 80>(q, k, v, o, bh, tq, tk, scale, stream);
    case 6: return launch_xattn_kt<64, 96>(q, k, v, o, bh, tq, tk, scale, stream);
    case 7: return launch_xattn_kt<64, 112>(q, k, v, o, bh, tq, tk, scale, stream);
    case 8: return launch_xattn_kt<64, 128>(q, k, v, o, bh, tq, tk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The forward's routes, chosen by the caller (`flash_fwd_route` in
// kernels/attention.py): the scalar kernel for fp32, the `mma.sync` kernel
// for bf16, the TMA / `wgmma` kernel for bf16 at D = 64 and T a multiple of
// 128. A route that does not fit the call is refused, not replaced.
enum FwdRoute { kScalar = 0, kMma = 1, kWgmma = 2 };

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, float scale, int route,
                       cudaStream_t stream) {
  if (route == kWgmma) {
    if constexpr (D == 64) {
      const long long rows = static_cast<long long>(bh) * seq;
      if (seq % FwdT::BM != 0 || rows >= (1LL << 31) ||
          encode_tiled() == nullptr)
        return cudaErrorInvalidValue;
      CUtensorMap maps[3];
      const void* ptrs[3] = {q, k, v};
      for (int m = 0; m < 3; ++m) {
        const cudaError_t err = tile_map(ptrs[m], rows, &maps[m]);
        if (err != cudaSuccess) return err;
      }
      // one persistent block per SM walks the (query tile, bh) items
      const int items = (seq / FwdT::BM) * bh;
      int device = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err != cudaSuccess) return err;
      err = allow_smem<flash_fwd_tma_kernel>(FwdT::smem_bytes);
      if (err != cudaSuccess) return err;
      const int grid = items < sms ? items : sms;
      flash_fwd_tma_kernel<<<grid, FwdT::THREADS, FwdT::smem_bytes, stream>>>(
          maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, seq, items,
          scale);
      return cudaGetLastError();

    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (route == kMma) {
    constexpr int ROWS = kFwdWarps * 16;
    constexpr size_t bytes =
        tdt::fwd_smem_bytes<D, kFwdWarps, kFwdStages<D>>();
    cudaError_t err = allow_smem<flash_fwd_mma_kernel<D>>(bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<D>
        <<<dim3((seq + ROWS - 1) / ROWS, bh), kFwdWarps * 32, bytes, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, seq,
            scale);
  } else if (route == kScalar) {
    const size_t bytes = (3 * tile_floats(D) + kTile * kPS) * sizeof(float);
    cudaError_t err = allow_smem<flash_fwd_kernel<D>>(bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<dim3((seq + kTile - 1) / kTile, bh), kThreads,
                          bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, seq,
        scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// bf16 inputs take a one-pass tensor-core kernel and a dq conversion (the
// TMA / `wgmma` kernel where it applies, else the `mma.sync` kernel), fp32
// inputs the two scalar kernels (which do not touch dq_acc).
template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       float* dq_acc, void* dq, void* dk, void* dv, int bh,
                       int seq, float scale, bool is_bf16, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  if (is_bf16) {
    if constexpr (D == 64) {
      const long long rows = static_cast<long long>(bh) * seq;
      if (seq % BwdT::BN == 0 && rows < (1LL << 31) &&
          encode_tiled() != nullptr) {
        CUtensorMap maps[4];
        const void* ptrs[4] = {q, k, v, g};
        for (int m = 0; m < 4; ++m) {
          const cudaError_t err = tile_map(ptrs[m], rows, &maps[m]);
          if (err != cudaSuccess) return err;
        }
        cudaError_t err = allow_smem<flash_bwd_tma_kernel>(BwdT::smem_bytes);
        if (err != cudaSuccess) return err;
        flash_bwd_tma_kernel<<<dim3(seq / BwdT::BN, bh), BwdT::THREADS,
                               BwdT::smem_bytes, stream>>>(
            maps[0], maps[1], maps[2], maps[3], lse, delta, dq_acc,
            static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        flash_bwd_dq_gather_kernel<<<dim3(seq / 64, bh), 512, 0, stream>>>(
            dq_acc, static_cast<bf16*>(dq), seq, scale);
        return cudaGetLastError();
      }
    }
    using B = Bwd<D>;
    cudaError_t err = allow_smem<flash_bwd_mma_kernel<D>>(B::smem_bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_mma_kernel<D>
        <<<dim3((seq + B::BN - 1) / B::BN, bh), B::THREADS, B::smem_bytes,
           stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse,
            delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            seq, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n8 = static_cast<long long>(bh) * seq * D / 8;
    flash_bwd_dq_convert_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256,
                                  0, stream>>>(dq_acc, static_cast<bf16*>(dq),
                                               n8, scale);
  } else {
    const float *qp = static_cast<const float*>(q),
                *kp = static_cast<const float*>(k),
                *vp = static_cast<const float*>(v),
                *gp = static_cast<const float*>(g);
    const size_t dq_bytes =
        (4 * tile_floats(D) + kTile * kPS) * sizeof(float);
    cudaError_t err = allow_smem<flash_bwd_dq_kernel<D>>(dq_bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D><<<grid, kThreads, dq_bytes, stream>>>(
        qp, kp, vp, gp, lse, delta, static_cast<float*>(dq), seq, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t kv_bytes =
        (4 * tile_floats(D) + 2 * kTile * kPS + 2 * kTile) * sizeof(float);
    err = allow_smem<flash_bwd_dkdv_kernel<D>>(kv_bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<D><<<grid, kThreads, kv_bytes, stream>>>(
        qp, kp, vp, gp, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), seq, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, seq, head_dim], contiguous and 16-byte aligned, of fp32
// (route 0, scalar) or bf16 (route 1, `mma.sync`; route 2, TMA and `wgmma`,
// head_dim 64 and seq a multiple of 128 only); lse: [bh, seq] fp32. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int bh, int seq,
                                   int head_dim, float scale, int route,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, bh, seq, scale, route, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, bh, seq, scale, route, s);
    case 128:
      return launch_fwd<128>(q, k, v, o, lse, bh, seq, scale, route, s);
    default: return cudaErrorInvalidValue;
  }
}

// As above, with g (the gradient of o) in the inputs' type, delta =
// rowsum(g * o) fp32 [bh, seq], and dq, dk, dv in the inputs' type. For bf16
// inputs dq_acc is an fp32 [bh, seq, head_dim] scratch that the caller has
// set to zero (the kernel sums dq into it with atomics, then converts); fp32
// inputs do not use it. All launches go to one stream.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* g, const float* lse,
                                   const float* delta, float* dq_acc,
                                   void* dq, void* dk, void* dv, int bh,
                                   int seq, int head_dim, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(q, k, v, g, lse, delta, dq_acc, dq, dk, dv, bh,
                            seq, scale, bf, s);
    case 64:
      return launch_bwd<64>(q, k, v, g, lse, delta, dq_acc, dq, dk, dv, bh,
                            seq, scale, bf, s);
    case 128:
      return launch_bwd<128>(q, k, v, g, lse, delta, dq_acc, dq, dk, dv, bh,
                             seq, scale, bf, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Cross-attention: q, o [bh, tq, head_dim] and k, v [bh, tk, head_dim],
// bf16, contiguous and 16-byte aligned; head_dim 64 and 1 <= tk <= 128 only.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_cross_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int tq, int tk, int head_dim,
                                         float scale, void* stream) {
  if (head_dim != 64) return cudaErrorInvalidValue;
  return launch_xattn(q, k, v, o, bh, tq, tk, scale,
                      static_cast<cudaStream_t>(stream));
}
