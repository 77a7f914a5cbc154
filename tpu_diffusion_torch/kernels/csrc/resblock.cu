// A whole ResBlock forward for Hopper (sm_90a), inference only.
//
// Replaces the TPU kernel of tpu_diffusion/kernels/resblock.py:
// `fused_resblock` (body `_resblock_kernel`, with `_conv3x3` and `_gn_stats`).
//
// Function, on NHWC x [B, H, W, Cin] with HWIO weights:
//   h   = silu(GN1(x))
//   h   = conv3x3(h, w1) + b1                    (+ emb_shift, additive mode)
//   h   = silu(GN2(h) * emb_scale + emb_shift)   (FiLM mode)
//         or silu(GN2(h))                        (additive mode)
//   h   = conv3x3(h, w2) + b2
//   out = (x  or  x . wskip + bskip) + h
// Both GroupNorms take fp32 statistics per (image, group).
//
// Bound on the H100: at the CIFAR UNet's shapes ([64, 32, 32, Cin] -> 128,
// bf16) one call does 38.7 GFLOP (Cin = 128) to 83.7 GFLOP (Cin = 384) on
// 34 to 68 MB of x, output and weights, so it is bound by operations: 39 to
// 85 us at the bf16 tensor-core rate against 10 to 20 us for the bytes.
//
// Design. The TPU kernel holds whole images in VMEM, because GN2 needs the
// statistics of all of conv1's output before conv2 can start. One
// [32, 32, 128] bf16 image is 256 KB and does not fit a block's 227 KB of
// shared memory, so here the function is a chain of three kernels on one
// stream:
//   1. `gn_partial_kernel`: per (image, 128-pixel chunk) partial sums of x
//      and x^2 for each GN1 group;
//   2. `conv3x3_kernel` (first use): finishes the GN1 statistics from the
//      partial sums, applies normalise + SiLU while it stages its input
//      tile, computes conv1 as an implicit GEMM, writes the mid tensor in
//      x's type and, from the fp32 accumulators (not from their roundings),
//      per (image, tile) partial sums for each GN2 group;
//   3. `conv3x3_kernel` (second use): the same with GN2 (and FiLM) on load,
//      the 1x1 skip product as one more pass of the same GEMM over raw x,
//      and the bias, skip and residual in the epilogue.
// The mid tensor ([64, 32, 32, 128] bf16: 16.8 MB) is written once and read
// once and stays in the 50 MB L2. x is read three times (statistics, conv1,
// skip), the second and third time mostly from L2.
//
// A block computes 128 pixels (whole image rows) by TN = 64 or 128 output
// channels. It walks the input channels in chunks of KC: the chunk of the
// haloed input slab ((rows + 2) x (W + 2) pixels) is staged into shared
// memory once, normalised and activated, with zeros for pixels outside the
// image (the padding applies after normalise + SiLU: a halo pixel adds 0,
// not silu(GN(0))), and serves all nine taps; the weights are staged one
// kernel row (three taps) at a time. bf16 runs on the tensor cores
// (`mma.sync` m16n8k16, fp32 accumulators, 8 warps of 32 pixels x TN / 2
// channels, fragments by `ldmatrix`; the weights stay HWIO, [k][n], and
// their fragments come transposed by `ldmatrix.trans`); fp32 runs scalar
// FMAs (8 pixels x TN / 16 channels per thread). No `cp.async` or TMA
// pipeline and no `wgmma` yet.
//
// Rounding. The TPU kernel folds each GroupNorm into one per-(image,
// channel) affine map rounded to the compute type and evaluates it and the
// SiLU in that type. Here the affine map and the SiLU are evaluated in
// fp32 and the activation is rounded once, to x's type, as it is written to
// the slab (so the products take bf16 operands, as on the TPU). Like the
// TPU kernel, conv1's output is rounded to x's type (the mid tensor) before
// GN2 is applied, while GN2's statistics come from the fp32 values. The
// output is rounded once.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTilePixels = 128;  // pixels per block: whole image rows
constexpr int kMaxGroups = 32;
constexpr int kMaxSmem = 232448;  // the most a block can opt in to

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// ---------------------------------------------------------------------------
// Partial GroupNorm sums of x: partials[b][chunk][g] = (sum, sum of squares).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                  int hw, int c, int groups, int rows) {
  constexpr int VEC = tdt::vec16<T>();
  extern __shared__ float red[];  // [2][rows][c]
  const int cv = c / VEC;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int row = threadIdx.x / cv, col = (threadIdx.x % cv) * VEC;
  if (row < rows) {
    float s[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
    const int p0 = chunk * kTilePixels;
    const int p1 = min(hw, p0 + kTilePixels);
    for (int p = p0 + row; p < p1; p += rows) {
      float v[VEC];
      tdt::load16(x + (static_cast<long long>(b) * hw + p) * c + col, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[row * c + col + i] = s[i];
      red[(rows + row) * c + col + i] = q[i];
    }
  }
  __syncthreads();
  const int cpg = c / groups;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    float gs = 0.f, gq = 0.f;
    for (int r = 0; r < rows; ++r)
      for (int j = 0; j < cpg; ++j) {
        gs += red[r * c + g * cpg + j];
        gq += red[(rows + r) * c + g * cpg + j];
      }
    float* out = partials +
        ((static_cast<long long>(b) * gridDim.x + chunk) * groups + g) * 2;
    out[0] = gs;
    out[1] = gq;
  }
}

// ---------------------------------------------------------------------------
// The accumulator tile of one thread: 128 pixels x TN channels per block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slab holds pixel rows of KC channels with a stride of KC + 16 bytes,
// the weight tile holds KC rows of TN channels with a stride of TN + 16
// bytes, so that the eight 16-byte rows of one `ldmatrix` matrix fall on
// distinct banks.
template <typename T, int KC, int TN>
struct Tile;

// bf16 on the tensor cores. Warp w: pixels (w % 4) * 32 .. + 31 (two
// 16-row A tiles), channels (w / 4) * TN / 2 .. (TN / 16 accumulator tiles
// of 8 columns). Fragment layouts as in the PTX ISA: lane = 4 g + c; an
// accumulator holds rows g and g + 8, columns 2c and 2c + 1.
template <int KC, int TN>
struct Tile<__nv_bfloat16, KC, TN> {
  using T = __nv_bfloat16;
  static constexpr int NT = TN / 16;
  static constexpr int kChans = 2 * NT;  // channels this thread holds
  static constexpr int kSlots = 32;      // threads that share a channel
  static constexpr int LDA = KC + 8, LDB = TN + 8;
  float acc[2][NT][4];
  int lane, wp, wn, g, c;
  int arow[2];  // slab pixel of this lane's `ldmatrix` row, per A tile

  __device__ __forceinline__ void init(int width) {
    lane = threadIdx.x % 32;
    wp = threadIdx.x / 32 % 4;
    wn = threadIdx.x / 128;
    g = lane / 4;
    c = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = wp * 32 + i * 16 + lane % 8 + 8 * (lane / 8 % 2);
      arow[i] = p / width * (width + 2) + p % width;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
    }
  }

  // acc += slab(pixels shifted by `shift` slab pixels) . wt over KC.
  __device__ __forceinline__ void tap(const T* slab, const T* wt, int shift) {
    const int ak = 8 * (lane / 16);
    const int bk = lane % 8 + 8 * (lane / 8 % 2);
    const int bn = wn * (TN / 2) + 8 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], slab + (arow[i] + shift) * LDA + kk * 16 + ak);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t bf[4];  // B fragments of two adjacent 8-column tiles
        ldmatrix_x4_trans(bf, wt + (kk * 16 + bk) * LDB + bn + j * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  __device__ __forceinline__ int slot() const { return wp * 8 + g; }
  __device__ __forceinline__ int chan(int j) const {
    return wn * (TN / 2) + j / 2 * 8 + 2 * c + j % 2;
  }
  // f(j, pixel, channel, value): j indexes this thread's channels.
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(2 * t + e % 2, wp * 32 + i * 16 + g + 8 * (e / 2),
            chan(2 * t + e % 2), acc[i][t][e]);
  }
};

// fp32 with scalar FMAs. Thread (ty, tx) of a 16 x 16 grid: pixels
// ty + 16 i (i < 8), channels tx + 16 j (j < TN / 16).
template <int KC, int TN>
struct Tile<float, KC, TN> {
  using T = float;
  static constexpr int NC = TN / 16;
  static constexpr int kChans = NC;
  static constexpr int kSlots = 16;
  static constexpr int LDA = KC + 4, LDB = TN + 4;
  float acc[8][NC];
  int ty, tx;
  int arow[8];

  __device__ __forceinline__ void init(int width) {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty + 16 * i;
      arow[i] = p / width * (width + 2) + p % width;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    }
  }

  __device__ __forceinline__ void tap(const T* slab, const T* wt, int shift) {
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float av[8], bv[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = slab[(arow[i] + shift) * LDA + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) bv[j] = wt[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ int slot() const { return ty; }
  __device__ __forceinline__ int chan(int j) const { return tx + 16 * j; }
  template <typename F>
  __device__ __forceinline__ void for_each(F f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) f(j, ty + 16 * i, chan(j), acc[i][j]);
  }
};

// ---------------------------------------------------------------------------
// GroupNorm + SiLU on load, 3x3 convolution, statistics or skip on store.
// ---------------------------------------------------------------------------

struct ConvArgs {
  const void* src;           // [B, H, W, K], the tensor to normalise
  const void* w;             // [3, 3, K, N]
  const float* bias;         // [N]
  const float* in_partials;  // [B, in_parts, in_groups, 2] sums of src
  int in_parts, in_groups;
  const float* gamma;        // [K]
  const float* beta;         // [K]
  const float* film_scale;   // [B, K] or null: GN(src) * scale + shift
  const float* film_shift;
  const float* add_shift;    // [B, N] or null: added to the output
  float* out_partials;       // [B, tiles, N / TN, out_groups, 2] or null
  int out_groups;
  void* dst;                 // [B, H, W, N]
  const void* skip_src;      // [B, H, W, skip_k] or null: added to the output
  const void* wskip;         // [skip_k, N] or null (identity: skip_k == N)
  const float* bskip;        // [N] with wskip
  int skip_k;
  int h, width, k, n;
  float eps;
};

// Stage channels [k0, k0 + KC) of the haloed slab of rows [y0 - 1, y0 + R]
// of one image. With `scale`: silu(src * scale + shift), zeros outside the
// image. Without: the raw values of the tile's own pixels only.
template <typename T, int KC>
__device__ __forceinline__ void stage_slab(const T* __restrict__ img, int ktot,
                                           int k0, int h, int width, int y0,
                                           int rows, T* slab,
                                           const float* scale,
                                           const float* shift) {
  constexpr int VEC = tdt::vec16<T>();
  constexpr int VPR = KC / VEC;
  constexpr int LDA = KC + VEC;
  const int sw = width + 2;
  const int total = (rows + 2) * sw * VPR;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int sp = idx / VPR, kv = idx % VPR * VEC;
    const int sy = sp / sw, sx = sp % sw;
    const int y = y0 - 1 + sy, x = sx - 1;
    const bool halo = sy == 0 || sy == rows + 1 || sx == 0 || sx == width + 1;
    if (scale == nullptr && halo) continue;
    float v[VEC];
    if (y >= 0 && y < h && x >= 0 && x < width) {
      tdt::load16(img + (static_cast<long long>(y) * width + x) * ktot + k0 +
                      kv, v);
      if (scale != nullptr) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          v[i] = silu(fmaf(v[i], scale[k0 + kv + i], shift[k0 + kv + i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    tdt::store16(slab + sp * LDA + kv, v);
  }
}

// Stage rows [k0, k0 + KC), columns [n0, n0 + TN) of `taps` consecutive
// [ktot, n] weight matrices.
template <typename T, int KC, int TN>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w,
                                              int taps, int ktot, int n,
                                              int k0, int n0, T* wt) {
  constexpr int VEC = tdt::vec16<T>();
  constexpr int VPR = TN / VEC;
  constexpr int LDB = TN + VEC;
  for (int idx = threadIdx.x; idx < taps * KC * VPR; idx += kThreads) {
    const int t = idx / (KC * VPR), r = idx % (KC * VPR);
    const int k = r / VPR, nv = r % VPR * VEC;
    *reinterpret_cast<uint4*>(wt + (t * KC + k) * LDB + nv) =
        *reinterpret_cast<const uint4*>(
            w + (static_cast<long long>(t) * ktot + k0 + k) * n + n0 + nv);
  }
}

template <int KC, int TN>
constexpr size_t header_floats(int k) {
  return 2 * static_cast<size_t>(k) + TN + 2 * kMaxGroups;
}

template <typename T, int KC, int TN>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const ConvArgs a) {
  using TileT = Tile<T, KC, TN>;
  constexpr int VEC = tdt::vec16<T>();
  constexpr int LDA = TileT::LDA, LDB = TileT::LDB;
  constexpr int LDO = TN + 4;  // fp32 row stride of the output tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = a.h, width = a.width, ktot = a.k, n = a.n;
  const int rows = kTilePixels / width;
  const int sw = width + 2;
  float* aff_scale = reinterpret_cast<float*>(smem);  // [K]
  float* aff_shift = aff_scale + ktot;                // [K]
  float* bias_s = aff_shift + ktot;                   // [TN]
  float* stat = bias_s + TN;                          // mean[32], rstd[32]
  unsigned char* work = reinterpret_cast<unsigned char*>(stat + 2 * kMaxGroups);
  T* slab = reinterpret_cast<T*>(work);               // [(rows+2)*sw][LDA]
  T* wt = slab + (rows + 2) * sw * LDA;               // [3][KC][LDB]

  const int b = blockIdx.z;
  const int y0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;

  // The input's group statistics from the partial sums, folded with gamma,
  // beta and FiLM into one affine map per channel of this image.
  const int cpg = ktot / a.in_groups;
  if (tid < a.in_groups) {
    float s = 0.f, q = 0.f;
    for (int p = 0; p < a.in_parts; ++p) {
      const float* e = a.in_partials +
          ((static_cast<long long>(b) * a.in_parts + p) * a.in_groups + tid) *
              2;
      s += e[0];
      q += e[1];
    }
    const float cnt = static_cast<float>(h) * width * cpg;
    const float mean = s / cnt;
    const float var = fmaxf(q / cnt - mean * mean, 0.f);
    stat[tid] = mean;
    stat[kMaxGroups + tid] = 1.f / sqrtf(var + a.eps);
  }
  __syncthreads();
  for (int k = tid; k < ktot; k += kThreads) {
    const int g = k / cpg;
    float sc = a.gamma[k] * stat[kMaxGroups + g];
    float sh = a.beta[k] - sc * stat[g];
    if (a.film_scale != nullptr) {
      const float ea = a.film_scale[static_cast<long long>(b) * ktot + k];
      sh = fmaf(sh, ea, a.film_shift[static_cast<long long>(b) * ktot + k]);
      sc *= ea;
    }
    aff_scale[k] = sc;
    aff_shift[k] = sh;
  }
  for (int j = tid; j < TN; j += kThreads) {
    float v = a.bias[n0 + j];
    if (a.add_shift != nullptr)
      v += a.add_shift[static_cast<long long>(b) * n + n0 + j];
    if (a.wskip != nullptr) v += a.bskip[n0 + j];
    bias_s[j] = v;
  }

  TileT tile;
  tile.init(width);
  const T* src = static_cast<const T*>(a.src) +
                 static_cast<long long>(b) * h * width * ktot;
  const T* w = static_cast<const T*>(a.w);
  for (int k0 = 0; k0 < ktot; k0 += KC) {
    for (int ky = 0; ky < 3; ++ky) {
      __syncthreads();  // the previous taps are consumed; the maps are set
      if (ky == 0)
        stage_slab<T, KC>(src, ktot, k0, h, width, y0, rows, slab, aff_scale,
                          aff_shift);
      stage_weights<T, KC, TN>(w + static_cast<long long>(ky) * 3 * ktot * n,
                               3, ktot, n, k0, n0, wt);
      __syncthreads();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        tile.tap(slab, wt + kx * KC * LDB, ky * sw + kx);
    }
  }
  if (a.wskip != nullptr) {  // the 1x1 skip: one more pass over raw x
    const T* xs = static_cast<const T*>(a.skip_src) +
                  static_cast<long long>(b) * h * width * a.skip_k;
    for (int k0 = 0; k0 < a.skip_k; k0 += KC) {
      __syncthreads();
      stage_slab<T, KC>(xs, a.skip_k, k0, h, width, y0, rows, slab, nullptr,
                        nullptr);
      stage_weights<T, KC, TN>(static_cast<const T*>(a.wskip), 1, a.skip_k, n,
                               k0, n0, wt);
      __syncthreads();
      tile.tap(slab, wt, sw + 1);
    }
  }
  __syncthreads();  // the slab and the weights are consumed: reuse them

  // Bias (and additive embedding); this thread's per-channel sums of the
  // fp32 outputs.
  float cs[TileT::kChans], cq[TileT::kChans];
#pragma unroll
  for (int j = 0; j < TileT::kChans; ++j) cs[j] = cq[j] = 0.f;
  tile.for_each([&](int j, int, int ch, float& v) {
    v += bias_s[ch];
    cs[j] += v;
    cq[j] = fmaf(v, v, cq[j]);
  });
  if (a.out_partials != nullptr) {
    float* part = reinterpret_cast<float*>(work);  // [2][kSlots][TN]
#pragma unroll
    for (int j = 0; j < TileT::kChans; ++j) {
      part[tile.slot() * TN + tile.chan(j)] = cs[j];
      part[(TileT::kSlots + tile.slot()) * TN + tile.chan(j)] = cq[j];
    }
    __syncthreads();
    const int cpo = n / a.out_groups;
    if (tid < a.out_groups) {
      const int lo = max(tid * cpo, n0), hi = min((tid + 1) * cpo, n0 + TN);
      float s = 0.f, q = 0.f;
      for (int ch = lo; ch < hi; ++ch)
        for (int sl = 0; sl < TileT::kSlots; ++sl) {
          s += part[sl * TN + ch - n0];
          q += part[(TileT::kSlots + sl) * TN + ch - n0];
        }
      float* out = a.out_partials +
          (((static_cast<long long>(b) * gridDim.x + blockIdx.x) * gridDim.y +
            blockIdx.y) * a.out_groups + tid) * 2;
      out[0] = s;
      out[1] = q;
    }
    __syncthreads();
  }

  // Through shared memory to 16-byte stores; the identity skip is added
  // here, in fp32, before the one rounding.
  float* otile = reinterpret_cast<float*>(work);  // [128][LDO]
  tile.for_each([&](int, int p, int ch, float& v) { otile[p * LDO + ch] = v; });
  __syncthreads();
  constexpr int VPR = TN / VEC;
  T* dst = static_cast<T*>(a.dst);
  const bool identity = a.skip_src != nullptr && a.wskip == nullptr;
  for (int idx = tid; idx < kTilePixels * VPR; idx += kThreads) {
    const int p = idx / VPR, nv = idx % VPR * VEC;
    const long long pix =
        (static_cast<long long>(b) * h + y0 + p / width) * width + p % width;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = otile[p * LDO + nv + i];
    if (identity) {
      float xv[VEC];
      tdt::load16(static_cast<const T*>(a.skip_src) + pix * n + n0 + nv, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] += xv[i];
    }
    tdt::store16(dst + pix * n + n0 + nv, v);
  }
}

template <typename T, int KC, int TN>
size_t conv_smem_bytes(int width, int k) {
  using TileT = Tile<T, KC, TN>;
  const size_t rows = kTilePixels / width;
  const size_t staged = ((rows + 2) * (width + 2) * TileT::LDA +
                         3 * KC * TileT::LDB) * sizeof(T);
  const size_t partial = 2 * TileT::kSlots * TN * sizeof(float);
  const size_t out = static_cast<size_t>(kTilePixels) * (TN + 4) *
                     sizeof(float);
  size_t work = staged > partial ? staged : partial;
  work = work > out ? work : out;
  return header_floats<KC, TN>(k) * sizeof(float) + work;
}

// Let the kernel use all the dynamic shared memory a block can have. Set
// once per kernel, on its first launch, so that a launch captured into a
// CUDA graph makes no attribute call.
template <typename T, int KC, int TN>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T, KC, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

template <typename T, int KC, int TN>
cudaError_t launch_conv(const ConvArgs& a, int batch, cudaStream_t stream) {
  const size_t bytes = conv_smem_bytes<T, KC, TN>(a.width, a.k);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, KC, TN>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.h / (kTilePixels / a.width), a.n / TN, batch);
  conv3x3_kernel<T, KC, TN><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KC>
cudaError_t launch_conv_tn(const ConvArgs& a, int batch, cudaStream_t stream) {
  if (a.n % 128 == 0) return launch_conv<T, KC, 128>(a, batch, stream);
  return launch_conv<T, KC, 64>(a, batch, stream);
}

template <typename T>
cudaError_t launch_conv_any(const ConvArgs& a, int batch, bool wide,
                            cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (wide) return launch_conv_tn<T, 64>(a, batch, stream);
  }
  return launch_conv_tn<T, 32>(a, batch, stream);
}

template <typename T>
cudaError_t launch_resblock(const void* x, const float* gn1_g,
                            const float* gn1_b, const void* w1,
                            const float* b1, const float* gn2_g,
                            const float* gn2_b, const float* emb_scale,
                            const float* emb_shift, const void* w2,
                            const float* b2, const void* wskip,
                            const float* bskip, void* mid, void* out,
                            float* partials1, float* partials2, int batch,
                            int h, int width, int cin, int cout, int groups1,
                            int groups2, float eps, cudaStream_t stream) {
  constexpr int VEC = tdt::vec16<T>();
  const int hw = h * width;
  const int chunks = (hw + kTilePixels - 1) / kTilePixels;
  const int cv = cin / VEC;
  const int rows = kThreads / cv;
  gn_partial_kernel<T>
      <<<dim3(chunks, batch), kThreads, 2 * rows * cin * sizeof(float),
         stream>>>(static_cast<const T*>(x), partials1, hw, cin, groups1,
                   rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 64-channel chunks where every reduction length allows them
  const bool wide = cin % 64 == 0 && cout % 64 == 0;
  const bool film = emb_scale != nullptr;
  ConvArgs c1 = {};
  c1.src = x;
  c1.w = w1;
  c1.bias = b1;
  c1.in_partials = partials1;
  c1.in_parts = chunks;
  c1.in_groups = groups1;
  c1.gamma = gn1_g;
  c1.beta = gn1_b;
  c1.add_shift = film ? nullptr : emb_shift;
  c1.out_partials = partials2;
  c1.out_groups = groups2;
  c1.dst = mid;
  c1.h = h;
  c1.width = width;
  c1.k = cin;
  c1.n = cout;
  c1.eps = eps;
  err = launch_conv_any<T>(c1, batch, wide, stream);
  if (err != cudaSuccess) return err;

  ConvArgs c2 = {};
  c2.src = mid;
  c2.w = w2;
  c2.bias = b2;
  c2.in_partials = partials2;
  c2.in_parts = (h / (kTilePixels / width)) * (cout / (cout % 128 ? 64 : 128));
  c2.in_groups = groups2;
  c2.gamma = gn2_g;
  c2.beta = gn2_b;
  c2.film_scale = emb_scale;
  c2.film_shift = film ? emb_shift : nullptr;
  c2.dst = out;
  c2.skip_src = x;
  c2.wskip = wskip;
  c2.bskip = bskip;
  c2.skip_k = cin;
  c2.h = h;
  c2.width = width;
  c2.k = cout;
  c2.n = cout;
  c2.eps = eps;
  return launch_conv_any<T>(c2, batch, wide, stream);
}

}  // namespace

// x: [batch, h, width, cin], w1: [3, 3, cin, cout], w2: [3, 3, cout, cout],
// wskip: [cin, cout] or null (then cin == cout), mid and out: [batch, h,
// width, cout], all contiguous, 16-byte aligned and of one type, fp32
// (is_bf16 = 0) or bf16. The vectors are fp32: gn1_g, gn1_b [cin]; b1,
// gn2_g, gn2_b, b2, bskip [cout]; emb_scale (null selects the additive
// mode) and emb_shift [batch, cout]. Scratch: partials1 [batch,
// ceil(h * width / 128), groups1, 2] and partials2 [batch, h * width / 128,
// cout / (128 or 64), groups2, 2], fp32. Needs: width divides 128, h a
// multiple of 128 / width, cin a multiple of 32, cout of 64, both at most
// 1024, at most 32 groups. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int resblock_forward(
    const void* x, const float* gn1_g, const float* gn1_b, const void* w1,
    const float* b1, const float* gn2_g, const float* gn2_b,
    const float* emb_scale, const float* emb_shift, const void* w2,
    const float* b2, const void* wskip, const float* bskip, void* mid,
    void* out, float* partials1, float* partials2, int batch, int h,
    int width, int cin, int cout, int groups1, int groups2, float eps,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || kTilePixels % width || h % (kTilePixels / width) ||
      cin % 32 || cout % 64 || cin > 1024 || cout > 1024 ||
      groups1 > kMaxGroups || groups2 > kMaxGroups || cin % groups1 ||
      cout % groups2 || batch <= 0 || batch > 65535 ||
      (wskip == nullptr && cin != cout))
    return cudaErrorInvalidValue;
  if (is_bf16)
    return launch_resblock<__nv_bfloat16>(
        x, gn1_g, gn1_b, w1, b1, gn2_g, gn2_b, emb_scale, emb_shift, w2, b2,
        wskip, bskip, mid, out, partials1, partials2, batch, h, width, cin,
        cout, groups1, groups2, eps, s);
  return launch_resblock<float>(
      x, gn1_g, gn1_b, w1, b1, gn2_g, gn2_b, emb_scale, emb_shift, w2, b2,
      wskip, bskip, mid, out, partials1, partials2, batch, h, width, cin, cout,
      groups1, groups2, eps, s);
}
