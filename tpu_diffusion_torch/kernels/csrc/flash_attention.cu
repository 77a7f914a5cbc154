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
// against 35 us for its 118 MB, so both are bound by operations. The
// backward as built does 14 T^2 d per slice, 120 GFLOP: with no atomics,
// the dq kernel and the dk/dv kernel each recompute s and dp. For bf16
// inputs every product runs on the tensor cores (`flash_fwd_mma_kernel`,
// `flash_bwd_dq_mma_kernel`, `flash_bwd_dkdv_mma_kernel`: `mma.sync`
// m16n8k16 with fp32 accumulators, 4 warps of 16 rows per 64-row tile; no
// `cp.async` pipeline or `wgmma` yet). For fp32 inputs the scalar kernels
// (`flash_fwd_kernel`, `flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`) do
// every product with fp32 FMAs on the CUDA cores (67 TFLOP/s, not the
// tensor cores' 989), with a floor of ~0.5 ms forward and ~1.8 ms backward
// (its 14 T^2 d) at that shape.
//
// Both sets share one design. A block owns 64 rows (query rows for the
// forward and dq kernels, key rows for dk/dv) and walks the other side in
// tiles of 64 staged in shared memory, with padded row strides so that the
// threads of a warp read distinct banks. The T x T logits never reach
// device memory. The forward keeps a running max and sum per row (online
// softmax), so any T works: the last tile is masked (keys past T get
// p = 0 and zero-filled K/V rows), rows past T compute and store nothing.
// The backward needs no online statistics: p comes from the saved lse. The
// dq kernel loops over key tiles, the dk/dv kernel over query tiles, so no
// output is written by two blocks and no atomics are needed. The scalar
// kernels run 256 threads as a 16 x 16 grid; each thread computes a 4 x 4
// block of the 64 x 64 logits (rows ty + 16i, columns tx + 16j) from fp32
// tiles and accumulates a 4 x d/16 block of its output.
//
// Rounding: the TPU forward normalises p over the whole row, rounds it to
// v's type and then multiplies by v. The scalar forward keeps p in fp32,
// accumulates p.v in fp32 and divides by the row sum once at the end; the
// tensor-core forward rounds the unnormalised p (<= 1) to bf16 for the p.v
// product, accumulates in fp32 and divides at the end. So a bf16 output
// differs from the TPU kernel's by the rounding of p to bf16 (2^-8 relative
// per term) plus the output's own rounding; an fp32 output differs only in
// summation order. The tensor-core logits are exact bf16 products summed
// in fp32, scaled by d^-1/2 after the product (the TPU kernel scales the
// fp32 q before it): a difference at fp32 rounding level. The tensor-core
// backward rounds p and ds to bf16 for the products that take them (dq,
// dk, dv), where the TPU kernels keep them fp32; the gradients, bf16
// themselves, differ by a few units of their last place.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
// Tensor-core kernels, bf16 only: one block of 4 warps per 64-row tile and
// bh; each warp owns 16 of the block's rows.
// ---------------------------------------------------------------------------
//
// The products run as `mma.sync.m16n8k16` (bf16 inputs, fp32 accumulators),
// with the fragment layouts of the PTX ISA: lane = 4 * g + c (g = lane / 4,
// c = lane % 4); an A fragment holds rows g and g + 8, columns 2c, 2c + 1
// and 2c + 8, 2c + 9 of a 16 x 16 tile; a B fragment holds column g, rows
// 2c, 2c + 1 and 2c + 8, 2c + 9 of a 16 x 8 tile; an accumulator holds
// rows g and g + 8, columns 2c and 2c + 1 of a 16 x 8 tile. So the
// accumulators of two adjacent 8-column tiles of a 16 x 64 product are,
// rounded to bf16, the A fragment of that product for the next one (p for
// p.v, ds for ds.k, ...). A B fragment wants two consecutive k-elements in
// one 32-bit word: for a product over d (q.k^T, g.v^T) the tiles are staged
// row-major, [64][d]; for a product over the tile's 64 rows (p.v, ds.k,
// p^T.g, ds^T.q) the second operand is staged transposed, [d][64].

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kLdT = kTile + 8;  // bf16 row stride of a transposed tile

__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 32-bit word holding elements [col, col + 1] of row `row` of a bf16
// tile with row stride `ld` elements.
__device__ __forceinline__ uint32_t word(const __nv_bfloat16* tile, int ld,
                                         int row, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + row * ld + col);
}

// Stage rows [row0, row0 + 64) of a [seq, D] bf16 slice into `rows`
// ([64][D + 8]) and/or, transposed, into `cols` ([D][64 + 8]); rows past
// seq are zero.
template <int D>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      int row0, int seq, __nv_bfloat16* rows,
                                      __nv_bfloat16* cols) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreadsMma) {
    const int r = idx / VPR, col = (idx % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * D + col);
    if (rows) *reinterpret_cast<uint4*>(rows + r * (D + 8) + col) = val;
    if (cols) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) cols[(col + i) * kLdT + r] = e[i];
    }
  }
}

// acc[t] = a . b^T for this warp's 16 rows of the staged [64][D + 8] tile
// a (rows w16 .. w16 + 15) and the 64 rows of b: a 16 x 64 product over D,
// as 8 accumulator tiles of 8 columns.
template <int D>
__device__ __forceinline__ void mma_abt(const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int w16,
                                        int g, int c, float (&acc)[8][4]) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int k = kk * 16 + 2 * c;
    const uint32_t af[4] = {
        word(a, LD, w16 + g, k), word(a, LD, w16 + g + 8, k),
        word(a, LD, w16 + g, k + 8), word(a, LD, w16 + g + 8, k + 8)};
#pragma unroll
    for (int t = 0; t < 8; ++t)
      mma_bf16(acc[t], af, word(b, LD, t * 8 + g, k),
               word(b, LD, t * 8 + g, k + 8));
  }
}

// acc[t] += p . x over the tile's 64 rows of x, for this warp's 16 x 64 p
// (accumulators of `mma_abt`, rounded to bf16) and x staged transposed,
// xt = [D][64 + 8]: a 16 x D product as D / 8 accumulator tiles.
template <int D>
__device__ __forceinline__ void mma_pxt(const float (&p)[8][4],
                                        const __nv_bfloat16* xt, int g, int c,
                                        float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int k = kk * 16 + 2 * c;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      mma_bf16(acc[t], pa, word(xt, kLdT, t * 8 + g, k),
               word(xt, kLdT, t * 8 + g, k + 8));
  }
}

// Write this warp's 16 x D accumulators, times `mul`, to rows row0 + w16 ..
// of a [seq, D] bf16 slice.
template <int D>
__device__ __forceinline__ void store_mma(__nv_bfloat16* __restrict__ dst,
                                          int row0, int seq, int w16, int g,
                                          int c, const float (&acc)[D / 8][4],
                                          float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + w16 + g + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16* out = dst + static_cast<long long>(row) * D;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(out + t * 8 + 2 * c) =
          __floats2bfloat162_rn(acc[t][2 * h] * mul, acc[t][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int seq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile * (D + 8);  // [64][D + 8]
  __nv_bfloat16* vt = ks + kTile * (D + 8);  // [D][64 + 8], V transposed

  const int w16 = threadIdx.x / 32 * 16;
  const int g = threadIdx.x % 32 / 4;
  const int c = threadIdx.x % 4;
  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  stage<D>(q + base, q0, seq, qs, nullptr);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the two row sums
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(k + base, k0, seq, ks, nullptr);
    stage<D>(v + base, k0, seq, nullptr, vt);
    __syncthreads();

    float s[8][4];
    mma_abt<D>(qs, ks, w16, g, c, s);
    // online softmax over rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[t][2 * h + e];
          x = k0 + t * 8 + 2 * c + e < seq ? x * scale : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      // the 4 lanes of a row are adjacent lanes of one quad
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mnew = fmaxf(m[h], tmax);  // finite: key k0 < seq is valid
      const float alpha = expf(m[h] - mnew);  // 0 on the first tile
      m[h] = mnew;
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[t][2 * h + e];
          x = expf(x - mnew);
          psum += x;
        }
      l[h] = l[h] * alpha + psum;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][2 * h] *= alpha;
        acc[t][2 * h + 1] *= alpha;
      }
    }
    mma_pxt<D>(s, vt, g, c, acc);  // acc += p . v, p rounded to bf16
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float total = l[h];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    l[h] = 1.f / total;
    const int row = q0 + w16 + g + 8 * h;
    if (c == 0 && row < seq)
      lse[static_cast<long long>(blockIdx.y) * seq + row] = m[h] + logf(total);
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      acc[t][2 * h] *= l[h];
      acc[t][2 * h + 1] *= l[h];
    }
  }
  store_mma<D>(o + base, q0, seq, w16, g, c, acc, 1.f);
}

// Backward, dq: one block per (64-row query tile, bh), looping over keys.
template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ g_in,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int seq, float scale) {
  constexpr int TILE = kTile * (D + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + TILE;   // [64][D + 8]
  __nv_bfloat16* ks = gs + TILE;   // [64][D + 8]
  __nv_bfloat16* vs = ks + TILE;   // [64][D + 8]
  __nv_bfloat16* kt = vs + TILE;   // [D][64 + 8], K transposed

  const int w16 = threadIdx.x / 32 * 16;
  const int g = threadIdx.x % 32 / 4;
  const int c = threadIdx.x % 4;
  const int q0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;
  stage<D>(q + base, q0, seq, qs, nullptr);
  stage<D>(g_in + base, q0, seq, gs, nullptr);
  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w16 + g + 8 * h;
    row_lse[h] = row < seq ? lse[rbase + row] : 0.f;
    row_delta[h] = row < seq ? delta[rbase + row] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    stage<D>(k + base, k0, seq, ks, kt);
    stage<D>(v + base, k0, seq, vs, nullptr);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<D>(qs, ks, w16, g, c, s);
    mma_abt<D>(gs, vs, w16, g, c, dp);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = k0 + t * 8 + 2 * c + e % 2 < seq
                            ? expf(s[t][e] * scale - row_lse[h]) : 0.f;
        s[t][e] = p * (dp[t][e] - row_delta[h]);  // ds
      }
    mma_pxt<D>(s, kt, g, c, acc);  // acc += ds . k
  }
  store_mma<D>(dq + base, q0, seq, w16, g, c, acc, scale);
}

// Backward, dk and dv: one block per (64-row key tile, bh), looping over
// queries. The products are taken transposed: s^T = k . q^T, dp^T = v . g^T,
// dv = p^T . g, dk = ds^T . q.
template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ g_in,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int seq,
                          float scale) {
  constexpr int TILE = kTile * (D + 8);
  constexpr int TILE_T = D * kLdT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + TILE;      // [64][D + 8]
  __nv_bfloat16* qs = vs + TILE;      // [64][D + 8]
  __nv_bfloat16* gs = qs + TILE;      // [64][D + 8]
  __nv_bfloat16* qt = gs + TILE;      // [D][64 + 8]
  __nv_bfloat16* gt = qt + TILE_T;    // [D][64 + 8]
  float* lses = reinterpret_cast<float*>(gt + TILE_T);  // [64]
  float* deltas = lses + kTile;                          // [64]

  const int w16 = threadIdx.x / 32 * 16;
  const int g = threadIdx.x % 32 / 4;
  const int c = threadIdx.x % 4;
  const int k0 = blockIdx.x * kTile;
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * seq;
  stage<D>(k + base, k0, seq, ks, nullptr);
  stage<D>(v + base, k0, seq, vs, nullptr);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    stage<D>(q + base, q0, seq, qs, qt);
    stage<D>(g_in + base, q0, seq, gs, gt);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lses[threadIdx.x] = row < seq ? lse[rbase + row] : 0.f;
      deltas[threadIdx.x] = row < seq ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    mma_abt<D>(ks, qs, w16, g, c, st);   // key rows, query columns
    mma_abt<D>(vs, gs, w16, g, c, dpt);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + 2 * c + e % 2;
        const float p = q0 + col < seq ? expf(st[t][e] * scale - lses[col])
                                       : 0.f;
        st[t][e] = p;                               // p^T
        dpt[t][e] = p * (dpt[t][e] - deltas[col]);  // ds^T
      }
    mma_pxt<D>(st, gt, g, c, dv_acc);   // dv += p^T . g
    mma_pxt<D>(dpt, qt, g, c, dk_acc);  // dk += ds^T . q
  }
  store_mma<D>(dk + base, k0, seq, w16, g, c, dk_acc, scale);
  store_mma<D>(dv + base, k0, seq, w16, g, c, dv_acc, 1.f);
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

// bf16 inputs take the tensor-core kernel, fp32 inputs the scalar kernel.
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int seq, float scale, bool bf16,
                       cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  if (bf16) {
    using bf = __nv_bfloat16;
    const size_t bytes = (2 * kTile * (D + 8) + D * kLdT) * sizeof(bf);
    cudaError_t err = allow_smem<flash_fwd_mma_kernel<D>>(bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_mma_kernel<D><<<grid, kThreadsMma, bytes, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<bf*>(o), lse, seq, scale);
  } else {
    const size_t bytes = (3 * tile_floats(D) + kTile * kPS) * sizeof(float);
    cudaError_t err = allow_smem<flash_fwd_kernel<D>>(bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, seq,
        scale);
  }
  return cudaGetLastError();
}

// bf16 inputs take the tensor-core kernels, fp32 inputs the scalar kernels.
template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int bh, int seq,
                       float scale, bool bf16, cudaStream_t stream) {
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  if (bf16) {
    using bf = __nv_bfloat16;
    const bf *qp = static_cast<const bf*>(q), *kp = static_cast<const bf*>(k),
             *vp = static_cast<const bf*>(v), *gp = static_cast<const bf*>(g);
    constexpr size_t tile = kTile * (D + 8), tile_t = D * kLdT;
    const size_t dq_bytes = (4 * tile + tile_t) * sizeof(bf);
    cudaError_t err = allow_smem<flash_bwd_dq_mma_kernel<D>>(dq_bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_mma_kernel<D><<<grid, kThreadsMma, dq_bytes, stream>>>(
        qp, kp, vp, gp, lse, delta, static_cast<bf*>(dq), seq, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t kv_bytes =
        (4 * tile + 2 * tile_t) * sizeof(bf) + 2 * kTile * sizeof(float);
    err = allow_smem<flash_bwd_dkdv_mma_kernel<D>>(kv_bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_mma_kernel<D><<<grid, kThreadsMma, kv_bytes, stream>>>(
        qp, kp, vp, gp, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
        seq, scale);
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
// (is_bf16 = 0) or bf16; lse: [bh, seq] fp32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int bh, int seq,
                                   int head_dim, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, bh, seq, scale, bf16, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, bh, seq, scale, bf16, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, bh, seq, scale, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

// As above, with g (the gradient of o) in the inputs' type, delta =
// rowsum(g * o) fp32 [bh, seq], and dq, dk, dv in the inputs' type. Launches
// the dq kernel, then the dk/dv kernel, on one stream.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* g, const float* lse,
                                   const float* delta, void* dq, void* dk,
                                   void* dv, int bh, int seq, int head_dim,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(q, k, v, g, lse, delta, dq, dk, dv, bh, seq,
                            scale, bf16, s);
    case 64:
      return launch_bwd<64>(q, k, v, g, lse, delta, dq, dk, dv, bh, seq,
                            scale, bf16, s);
    case 128:
      return launch_bwd<128>(q, k, v, g, lse, delta, dq, dk, dv, bh, seq,
                             scale, bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}
