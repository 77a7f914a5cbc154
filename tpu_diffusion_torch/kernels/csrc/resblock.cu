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
// The chain. The TPU kernel holds whole images in VMEM, because GN2 needs
// the statistics of all of conv1's output before conv2 can start. One
// [32, 32, 128] bf16 image is 256 KB and does not fit a block's 227 KB of
// shared memory, so here the function is a chain of kernels on one stream:
//   1. `gn_partial_kernel`: per (image, 128-pixel chunk) partial sums of x
//      and x^2 for each GN1 group;
//   2. conv1: the GN1 statistics from the partial sums, normalise + SiLU of
//      x, conv1 as an implicit GEMM; writes the mid tensor in x's type and,
//      from the fp32 accumulators (not from their roundings), per (image,
//      tile, channel tile) partial sums for each GN2 group, in a fixed
//      order and without atomics (two calls are bitwise equal);
//   3. conv2: the same with GN2 (and FiLM) over mid, the 1x1 skip product
//      as more k-steps over raw x on the same accumulators, and the bias,
//      skip and residual in the epilogue.
// The mid tensor ([64, 32, 32, 128] bf16: 16.8 MB) is written once and read
// once and stays in the 50 MB L2. The padding applies after normalise +
// SiLU: a halo pixel adds 0, not silu(GN(0)).
//
// Routes, picked by the caller (`resblock_route` in kernels/resblock.py,
// which also sets the tile geometry and so the scratch shapes) and refused
// by the entry point where they do not fit:
//   "wgmma" (bf16, W in {8, 16, 32, 64}, 256 / W dividing H, Cin % 32 = 0,
//   Cout % 128 = 0: every CIFAR engine shape). Each conv is two kernels:
//   `gn_act_kernel` writes act = silu(GN(input)) in bf16 once per element
//   (into a scratch tensor), then `conv3x3_wgmma_kernel` computes 256
//   pixels (whole rows) x 128 output channels per block with two consumer
//   warpgroups (128 pixels each: two m64n128 fp32 accumulators, 128
//   registers a thread) and one producer thread. What it does about the
//   four things that held the `mma.sync` design at 5.6x its bound:
//   - products: `wgmma` m64n128k16 with both operands in shared memory, A
//     K-major in the 64-byte swizzle, B (the weights, [k][n] as HWIO holds
//     them) MN-major in the 128-byte swizzle;
//   - overlap: every operand comes by TMA on mbarriers, the weights of one
//     tap (32 input x 128 output channels, 8 KB) into a ring of eight
//     slots, each chunk's input into one of two stages, so loads run ahead
//     of the products; the consumers only issue products and free slots;
//   - weight traffic: 256-pixel tiles halve the L2 reads of the weights
//     against 128-pixel ones (256 blocks per conv at [64, 32, 32, .]);
//   - the A operand: a tap's 64 output pixels are not a uniform stride into
//     a haloed slab whose rows are W + 2 wide, so each chunk's input comes
//     as three TMA boxes of act shifted by kx - 1 columns, rows exactly W
//     wide, zero-filled outside the image (the padding after the
//     activation): every tap's A tile is rows [ky, ky + rows) of copy kx,
//     at a 512-byte aligned offset that a descriptor addresses directly.
//   GN + SiLU sits in its own pass because applying it while staging the
//   input cost more than the pass: by the consumers it left the tensor
//   cores idle (1.9x slower), by three stager warps it had too few loads
//   in flight (2.9x slower) (PERF.md). The epilogue stores the bf16 tile
//   by TMA; the identity skip's x tile comes by TMA too. x is read three
//   times (GN1 sums, the act pass, the skip) and act three times per conv
//   (once per copy), mostly from L2: bytes stay far below the products.
//   "mma" (other bf16 shapes) and "scalar" (fp32): `conv3x3_kernel`, 128
//   pixels x 64 or 128 channels per block, 256 threads, `mma.sync` m16n8k16
//   with `ldmatrix` fragments (bf16) or scalar FMAs (fp32); GN + SiLU is
//   applied while the slab of KC input channels is staged through
//   registers, once per chunk, the weights one kernel row (three taps) at a
//   time; no asynchronous pipeline.
// Every mbarrier wait traps after 2^22 polls: a fault in the protocol fails
// the launch instead of hanging the card.
//
// Rounding. The TPU kernel folds each GroupNorm into one per-(image,
// channel) affine map rounded to the compute type and evaluates it and the
// SiLU in that type. Here the affine map and the SiLU are evaluated in
// fp32 (`t / (1 + expf(-t))`, as PyTorch rounds it) and the activation is
// rounded once, to x's type, as it is written to the slab or to act (so the
// products take bf16 operands, as on the TPU). Like the TPU kernel, conv1's output is
// rounded to x's type (the mid tensor) before GN2 is applied, while GN2's
// statistics come from the fp32 values. The output is rounded once.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
#pragma unroll 4
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


// The output's constant per channel of block columns [n0, n0 + TN) of
// image b: the bias, the additive embedding, the skip's bias.
template <int TN>
__device__ __forceinline__ void channel_bias(const ConvArgs& a, int b, int n0,
                                             int tid, int threads,
                                             float* bias_s) {
  for (int j = tid; j < TN; j += threads) {
    float v = a.bias[n0 + j];
    if (a.add_shift != nullptr)
      v += a.add_shift[static_cast<long long>(b) * a.n + n0 + j];
    if (a.wskip != nullptr) v += a.bskip[n0 + j];
    bias_s[j] = v;
  }
}

// The input's group statistics from the partial sums, folded with gamma,
// beta and FiLM into one affine map per channel of image b (aff_scale,
// aff_shift [K]). Threads [0, threads) take part; `sync` is their barrier,
// and the maps are ready after their next one.
template <typename Sync>
__device__ __forceinline__ void affine_maps(const ConvArgs& a, int b, int tid,
                                            int threads, float* stat,
                                            float* aff_scale,
                                            float* aff_shift, Sync sync) {
  const int ktot = a.k;
  const int cpg = ktot / a.in_groups;
  if (tid < a.in_groups) {
    float s = 0.f, q = 0.f;
#pragma unroll 8
    for (int p = 0; p < a.in_parts; ++p) {
      const float* e = a.in_partials +
          ((static_cast<long long>(b) * a.in_parts + p) * a.in_groups + tid) *
              2;
      s += e[0];
      q += e[1];
    }
    const float cnt = static_cast<float>(a.h) * a.width * cpg;
    const float mean = s / cnt;
    const float var = fmaxf(q / cnt - mean * mean, 0.f);
    stat[tid] = mean;
    stat[kMaxGroups + tid] = 1.f / sqrtf(var + a.eps);
  }
  sync();
  for (int k = tid; k < ktot; k += threads) {
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

  affine_maps(a, b, tid, kThreads, stat, aff_scale, aff_shift,
              [] { __syncthreads(); });
  channel_bias<TN>(a, b, n0, tid, kThreads, bias_s);

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


// ---------------------------------------------------------------------------
// The "wgmma" route (bf16): GN + SiLU once per element by `gn_act_kernel`,
// then each conv as a warp-specialised implicit GEMM: its input tiles and
// weights by TMA, its products by `wgmma`.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kPixels = 256;   // pixels per block: whole image rows
constexpr int kN = 128;        // output channels per block
constexpr int kKC = 32;        // input channels per tap: 64-byte rows
constexpr int kStages = 8;     // weight tiles in their ring
constexpr int kStage = kKC * kN * 2;  // bytes of one [32][128] weight tile
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kConsumers = 256;
constexpr int kInFlight = 1;   // taps whose products may run at once
constexpr int kLDS = kN + 8;   // row stride of the epilogue's fp32 sums
constexpr int kBars = 2 * kStages + 5;
constexpr int kActPixels = 128;  // pixels per block of `gn_act_kernel`

__host__ __device__ constexpr bool width_ok(int width) {
  return width == 8 || width == 16 || width == 32 || width == 64;
}
// One copy of the input slab: (rows + 2) x W pixels of 32 channels (64
// bytes each, in the 64-byte swizzle), shifted by kx; a chunk's input
// (one A stage) holds three.
__host__ __device__ constexpr int copy_bytes(int width) {
  return (kPixels / width + 2) * width * kKC * 2;
}
// Two A stages and the weight ring; reused by the epilogue for the bf16
// output tile and GN2's channel sums.
__host__ __device__ constexpr int region_bytes(int width) {
  return 2 * 3 * copy_bytes(width) + kStages * kStage;
}
constexpr int kOutBytes = kPixels * kN * 2;           // the bf16 output tile
constexpr int kSumBytes = (2 * 64 * kLDS + 2 * kN) * 4;  // GN2's sums
__host__ __device__ constexpr size_t smem_bytes(int width) {
  return 1024 + static_cast<size_t>(region_bytes(width)) +
         (kN + 2 * kMaxGroups) * 4 + kBars * 8;
}
static_assert(kOutBytes + kSumBytes <= region_bytes(8) &&
                  2 * kOutBytes <= region_bytes(8),
              "epilogue room");
static_assert(smem_bytes(64) <= kMaxSmem, "shared memory");

// Barrier over the two consumer warpgroups (barrier 0 is the block's).
__device__ __forceinline__ void consumer_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// silu(raw * scale + shift) of 8 bf16 channels, rounded to bf16.
__device__ __forceinline__ uint4 activate(uint4 raw, const float* scale,
                                          const float* shift) {
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = tdt::pack_bf16(
        silu(fmaf(__bfloat162float(v[2 * i]), scale[2 * i], shift[2 * i])),
        silu(fmaf(__bfloat162float(v[2 * i + 1]), scale[2 * i + 1],
                  shift[2 * i + 1])));
  return out;
}

}  // namespace wg

// act = silu(GN(src) (* FiLM scale + shift)) in bf16 for pixels [p0, p0 +
// 128) of one image (block (p0 / 128, image)): the statistics from the
// partial sums, the affine map per channel in fp32, one rounding.
__global__ void __launch_bounds__(kThreads)
gn_act_kernel(const ConvArgs a, __nv_bfloat16* __restrict__ act) {
  extern __shared__ float act_maps[];  // scale [K], shift [K], stat [64]
  const int k = a.k, b = blockIdx.y;
  float* aff_scale = act_maps;
  float* aff_shift = aff_scale + k;
  float* stat = aff_shift + k;
  affine_maps(a, b, threadIdx.x, kThreads, stat, aff_scale, aff_shift,
              [] { __syncthreads(); });
  __syncthreads();
  const int hw = a.h * a.width, kv = k / 8;
  const int p0 = blockIdx.x * wg::kActPixels;
  const int nvec = min(wg::kActPixels, hw - p0) * kv;
  const long long base = (static_cast<long long>(b) * hw + p0) * k;
  const uint4* src =
      reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.src) + base);
  uint4* dst = reinterpret_cast<uint4*>(act + base);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = i % kv * 8;
    dst[i] = wg::activate(src[i], aff_scale + c, aff_shift + c);
  }
}

// 3x3 convolution of act (and the 1x1 skip over raw x) for 256 pixels
// (whole rows of one image) x 128 output channels per block. Warpgroups 0
// and 1 (the consumers) own pixels [128 wg, 128 wg + 128) as two m64n128
// fp32 accumulators. One thread of warpgroup 2 (the producer) streams by
// TMA, each on its own mbarriers: the weight tiles ([32 input][128 output
// channels] of one tap, two boxes of 64 columns in the 128-byte swizzle)
// into a ring of eight slots, and each chunk's input into one of two A
// stages. A main chunk is 32 input channels of act: three boxes of (rows +
// 2) x W pixels at columns shifted by kx - 1, the parts outside the image
// filled with zeros (the padding after the activation), in the 64-byte
// swizzle, so that every tap's A operand (slab rows [ky, ky + rows) of copy
// kx) sits at a 512-byte aligned offset; nine taps. A skip chunk is up to
// three groups of 32 channels of raw x (rows x W pixels each, in the place
// of copy s's rows 1..rows); one tap each. For each tap the consumers wait
// for its weight tile, issue four `wgmma` (two k-steps of 16 for each
// accumulator; B MN-major from the ring), let at most kInFlight taps'
// products run and free the slots (and A stages) of the others. The
// epilogue adds the bias, sums GN2's partials (conv1), adds the identity
// skip (conv2) and stores the bf16 tile by TMA.
__global__ void __launch_bounds__(wg::kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap skip_map,
                     const __grid_constant__ CUtensorMap act_map,
                     const __grid_constant__ CUtensorMap xin_map,
                     const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap dst_map,
                     const ConvArgs a) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* region = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = a.h, width = a.width, ktot = a.k;
  const int rows = kPixels / width;
  const int copy = copy_bytes(width);
  unsigned char* ring = region + 6 * copy;           // [kStages][kStage]
  float* bias_s = reinterpret_cast<float*>(ring + kStages * kStage);  // [kN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kN + 2 * kMaxGroups);
  uint64_t* empty = full + kStages;
  uint64_t* a_full = empty + kStages;                // [2]
  uint64_t* a_empty = a_full + 2;                    // [2]
  uint64_t* x_full = a_empty + 2;

  const int b = blockIdx.z, tile = blockIdx.x;
  const int y0 = tile * rows, n0 = blockIdx.y * kN;
  const int nmain = ktot / kKC;
  const int nsub = a.wskip != nullptr ? a.skip_k / kKC : 0;
  const int nchunks = nmain + (nsub + 2) / 3;
  const int warpgroup = threadIdx.x / 128;
  auto stage = [&](int c) { return region + (c & 1) * 3 * copy; };
  auto taps = [&](int c) {
    return c < nmain ? 9 : min(3, nsub - (c - nmain) * 3);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tdt::mbar_init(full + s, 1);
      tdt::mbar_init(empty + s, 2);
    }
    for (int i = 0; i < 2; ++i) {
      tdt::mbar_init(a_full + i, 1);
      tdt::mbar_init(a_empty + i, 2);
    }
    tdt::mbar_init(x_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 2) {  // the producer: one thread issues every copy
    tdt::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      // chunk c's input into A stage c % 2, once chunk c - 2's products are
      // done
      auto load_a = [&](int c) {
        uint64_t* bar = a_full + (c & 1);
        if (c >= 2) tdt::mbar_wait(a_empty + (c & 1), ((c >> 1) - 1) & 1);
        if (c < nmain) {
          tdt::mbar_expect_tx(bar, 3 * copy);
          for (int kx = 0; kx < 3; ++kx)
            tdt::tma_load_4d(stage(c) + kx * copy, &act_map, c * kKC, kx - 1,
                             y0 - 1, b, bar);
        } else {
          tdt::mbar_expect_tx(bar, taps(c) * kPixels * kKC * 2);
          for (int s = 0; s < taps(c); ++s)
            tdt::tma_load_4d(stage(c) + s * copy + width * kKC * 2, &xin_map,
                             ((c - nmain) * 3 + s) * kKC, 0, y0, b, bar);
        }
      };
      int q = 0;
      auto load_w = [&](const CUtensorMap* map, int row) {
        const int slot = q % kStages;
        if (q >= kStages) tdt::mbar_wait(empty + slot, (q / kStages - 1) & 1);
        tdt::mbar_expect_tx(full + slot, kStage);
        unsigned char* dst = ring + slot * kStage;
        tdt::tma_load_2d(dst, map, n0, row, full + slot);
        tdt::tma_load_2d(dst + kStage / 2, map, n0 + 64, row, full + slot);
        ++q;
      };
      load_a(0);
      for (int c = 0; c < nchunks; ++c) {
        for (int t = 0; t < taps(c); ++t)
          if (c < nmain)
            load_w(&w_map, t * ktot + c * kKC);
          else
            load_w(&skip_map, ((c - nmain) * 3 + t) * kKC);
        if (c + 1 < nchunks) load_a(c + 1);
      }
    }
    return;
  }

  tdt::regs_alloc<240>();
  const int tid = threadIdx.x;  // 0..255
  const int wt = tid % 128;
  channel_bias<kN>(a, b, n0, tid, kConsumers, bias_s);  // read after a sync

  float acc[2][16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  int q = 0;          // weight tiles issued so far
  int done = 0;       // weight tiles whose products are done, slots freed
  int issued = 0;     // chunks whose taps are all issued
  int released = 0;   // chunks whose A stage is freed
  int ends[2] = {0, 0};  // q after the last tap of chunks issued - 2, - 1
  // Issue the four products of one tap: A at `a0` (this warpgroup's 128
  // pixels), B the next weight tile.
  auto issue = [&](const unsigned char* a0) {
    const int slot = q % kStages;
    const uint64_t da0 = tdt::wgmma_desc_of(a0, 16, 512, 2);
    const uint64_t da1 = tdt::wgmma_desc_of(a0 + 64 * 64, 16, 512, 2);
    const uint64_t db =
        tdt::wgmma_desc_of(ring + slot * kStage, kStage / 2, 1024, 1);
    tdt::mbar_wait(full + slot, (q / kStages) & 1);
    tdt::fence_regs(acc[0]);
    tdt::fence_regs(acc[1]);
    tdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      tdt::wgmma_m64n128k16_ss<1>(acc[0], da0 + 2 * kk, db + 128 * kk, 1);
      tdt::wgmma_m64n128k16_ss<1>(acc[1], da1 + 2 * kk, db + 128 * kk, 1);
    }
    tdt::wgmma_commit();
    ++q;
  };
  // At most kInFlight taps' products still run: free the others' weight
  // slots and the A stages of chunks whose products are all done.
  auto retire = [&]() {
    tdt::wgmma_wait<kInFlight>();
    tdt::fence_regs(acc[0]);
    tdt::fence_regs(acc[1]);
    for (; done < q - kInFlight; ++done)
      if (wt == 0) tdt::mbar_arrive(empty + done % kStages);
    for (; released < issued && done >= ends[released & 1]; ++released)
      if (wt == 0) tdt::mbar_arrive(a_empty + (released & 1));
  };

  const int arow = warpgroup * 128 * kKC * 2;  // this warpgroup's first pixel
  for (int c = 0; c < nchunks; ++c) {
    // Chunk c's input waits for chunk c - 2's A stage: after a chunk of
    // fewer taps than kInFlight, let every product finish to free it.
    if (released < c - 1) {
      tdt::wgmma_wait<0>();
      tdt::fence_regs(acc[0]);
      tdt::fence_regs(acc[1]);
      for (; done < q; ++done)
        if (wt == 0) tdt::mbar_arrive(empty + done % kStages);
      for (; released < issued; ++released)
        if (wt == 0) tdt::mbar_arrive(a_empty + (released & 1));
    }
    tdt::mbar_wait(a_full + (c & 1), (c >> 1) & 1);
    const unsigned char* in = stage(c) + arow;
    if (c < nmain) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        issue(in + (t % 3) * copy + t / 3 * width * kKC * 2);
        retire();
      }
    } else {
      for (int s = 0; s < taps(c); ++s) {
        issue(in + s * copy + width * kKC * 2);
        retire();
      }
    }
    ends[c & 1] = q;
    issued = c + 1;
  }
  tdt::wgmma_wait<0>();
  tdt::fence_regs(acc[0]);
  tdt::fence_regs(acc[1]);
  consumer_sync(1);  // every product is done: the region is free
  const bool identity = a.skip_src != nullptr && a.wskip == nullptr;
  if (identity && tid == 0) {  // x's tile for the identity skip
    const int row = (b * h + y0) * width;
    unsigned char* xdst = region + kOutBytes;
    tdt::mbar_expect_tx(x_full, kOutBytes);
    tdt::tma_load_2d(xdst, &x_map, n0, row, x_full);
    tdt::tma_load_2d(xdst + kOutBytes / 2, &x_map, n0 + 64, row, x_full);
  }

  // Bias (and additive embedding, the skip's bias).
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][t][e] += bias_s[8 * t + 2 * cq + e % 2];

  const int rowb = warpgroup * 128 + (wt / 32) * 16 + g;  // pixel of e < 2
  if (a.out_partials != nullptr) {
    // Per-channel sums of the fp32 outputs for GN2, in a fixed order: this
    // thread's four pixels, then over the 64 (warp, row group) places
    // through shared memory, then a group's channels.
    float* sums = reinterpret_cast<float*>(region + kOutBytes);  // [2][64][kLDS]
    float* red = sums + 2 * 64 * kLDS;                            // [2][kN]
    const int place = warp * 8 + g;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float s[2], sq[2];
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        s[hc] = sq[hc] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = hc; e < 4; e += 2) {
            s[hc] += acc[i][t][e];
            sq[hc] = fmaf(acc[i][t][e], acc[i][t][e], sq[hc]);
          }
      }
      *reinterpret_cast<float2*>(sums + place * kLDS + 8 * t + 2 * cq) =
          make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(sums + (64 + place) * kLDS + 8 * t +
                                 2 * cq) = make_float2(sq[0], sq[1]);
    }
    consumer_sync(1);
    {
      const int which = tid / kN, ch = tid % kN;
      float total = 0.f;
      for (int r = 0; r < 64; ++r) total += sums[(which * 64 + r) * kLDS + ch];
      red[which * kN + ch] = total;
    }
    consumer_sync(1);
    const int cpo = a.n / a.out_groups;
    if (tid < a.out_groups) {
      const int lo = max(tid * cpo, n0), hi = min((tid + 1) * cpo, n0 + kN);
      float s = 0.f, sq = 0.f;
      for (int ch = lo; ch < hi; ++ch) {
        s += red[ch - n0];
        sq += red[kN + ch - n0];
      }
      float* out = a.out_partials +
          (((static_cast<long long>(b) * gridDim.x + tile) * gridDim.y +
            blockIdx.y) * a.out_groups + tid) * 2;
      out[0] = s;
      out[1] = sq;
    }
  }

  // The identity skip (its tile of x, by TMA, in the output tile's layout)
  // added in fp32, one rounding to bf16, into the output tile in shared
  // memory ([2 halves of 64 channels][256 pixels], 128-byte rows in the
  // 128-byte swizzle, as the TMA store reads them).
  __nv_bfloat16* otile = reinterpret_cast<__nv_bfloat16*>(region);
  const __nv_bfloat16* xtile = otile + kPixels * kN;
  if (identity) tdt::mbar_wait(x_full, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = rowb + i * 64 + 8 * hr;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int at = (t / 8) * kPixels * 64 + tdt::swz(p, (t % 8) * 8 + 2 * cq);
        float v0 = acc[i][t][2 * hr], v1 = acc[i][t][2 * hr + 1];
        if (identity) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(xtile + at);
          v0 += __bfloat162float(xv.x);
          v1 += __bfloat162float(xv.y);
        }
        *reinterpret_cast<uint32_t*>(otile + at) = tdt::pack_bf16(v0, v1);
      }
    }
  tdt::fence_async_smem();  // the tile, visible to the TMA store
  consumer_sync(1);
  if (tid == 0) {
    const int row = (b * h + y0) * width;
    tdt::tma_store_2d(&dst_map, otile, n0, row);
    tdt::tma_store_2d(&dst_map, otile + kPixels * 64, n0 + 64, row);
    tdt::bulk_commit();
    tdt::bulk_wait_read();  // the tile is read before the block ends
  }
}

// A 2-D map of a [rows][cols] bf16 matrix in boxes of 32 rows x 64 columns
// with the 128-byte swizzle (the weight tiles).
cudaError_t weight_map(const void* ptr, int rows, int cols, CUtensorMap* map) {
  const tdt::EncodeTiled encode = tdt::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, wg::kKC}, elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D map of an NHWC bf16 tensor [batch][h][width][c] in boxes of 32
// channels x width x `box_rows` pixels x 1 image, in the 64-byte swizzle;
// the parts of a box outside the tensor (the halo at the image's edges) are
// filled with zeros.
cudaError_t pixel_map(const void* ptr, int batch, int h, int width, int c,
                      int box_rows, CUtensorMap* map) {
  const tdt::EncodeTiled encode = tdt::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(width),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(width) * c * 2,
                                 static_cast<cuuint64_t>(h) * width * c * 2};
  const cuuint32_t box[4] = {wg::kKC, static_cast<cuuint32_t>(width),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D map of a [rows][cols] bf16 pixel matrix in boxes of 256 rows x 64
// columns with the 128-byte swizzle (a conv block's output tile, or x's
// tile for the identity skip, by halves).
cudaError_t out_map(void* ptr, int rows, int cols, CUtensorMap* map) {
  const tdt::EncodeTiled encode = tdt::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, wg::kPixels}, elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The "wgmma" route's conv of `a` over the activation `act` of a.src.
cudaError_t launch_conv_wgmma(const ConvArgs& a, const void* act, int batch,
                              cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int rows = wg::kPixels / a.width;
  CUtensorMap w_map, skip_map, act_map, xin_map, x_map, dst_map;
  const int pixels = batch * a.h * a.width;
  cudaError_t err = weight_map(a.w, 9 * a.k, a.n, &w_map);
  if (err == cudaSuccess) err = out_map(a.dst, pixels, a.n, &dst_map);
  x_map = dst_map;
  if (err == cudaSuccess && a.skip_src != nullptr && a.wskip == nullptr)
    err = out_map(const_cast<void*>(a.skip_src), pixels, a.n, &x_map);
  if (err == cudaSuccess)
    err = pixel_map(act, batch, a.h, a.width, a.k, rows + 2, &act_map);
  skip_map = w_map;
  xin_map = act_map;
  if (err == cudaSuccess && a.wskip != nullptr) {
    err = weight_map(a.wskip, a.skip_k, a.n, &skip_map);
    if (err == cudaSuccess)
      err = pixel_map(a.skip_src, batch, a.h, a.width, a.skip_k, rows,
                      &xin_map);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(a.h * a.width / wg::kPixels, a.n / wg::kN, batch);
  conv3x3_wgmma_kernel<<<grid, wg::kThreads, wg::smem_bytes(a.width),
                         stream>>>(w_map, skip_map, act_map, xin_map, x_map,
                                   dst_map, a);
  return cudaGetLastError();
}

// act = silu(GN(a.src) ...) for the "wgmma" route's conv.
cudaError_t launch_act(const ConvArgs& a, void* act, int batch,
                       cudaStream_t stream) {
  const int hw = a.h * a.width;
  const dim3 grid((hw + wg::kActPixels - 1) / wg::kActPixels, batch);
  gn_act_kernel<<<grid, kThreads, (2 * a.k + 2 * kMaxGroups) * sizeof(float),
                  stream>>>(a, static_cast<__nv_bfloat16*>(act));
  return cudaGetLastError();
}

// The routes, in the order of `ROUTES` in kernels/resblock.py.
enum Route { kScalar = 0, kMma = 1, kWgmma = 2 };

// Whether `route` with the tile geometry (pixels, channels per conv block)
// fits the call: the entry point refuses what does not.
bool route_fits(int route, int tile_pixels, int channel_tile, int h,
                int width, int cin, int cout, bool bf16) {
  if (route == kWgmma)
    return bf16 && wg::width_ok(width) && h % (wg::kPixels / width) == 0 &&
           cin % wg::kKC == 0 && cout % wg::kN == 0 &&
           tile_pixels == wg::kPixels && channel_tile == wg::kN;
  if (route != kMma && route != kScalar) return false;
  return bf16 == (route == kMma) && kTilePixels % width == 0 &&
         h % (kTilePixels / width) == 0 && tile_pixels == kTilePixels &&
         channel_tile == (cout % 128 ? 64 : 128);
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
                            int groups2, float eps, int route, int tile_pixels,
                            int channel_tile, void* act, cudaStream_t stream) {
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

  auto conv = [&](const ConvArgs& a) {
    if (route == kWgmma) {  // GN + SiLU into act, then the conv over it
      cudaError_t e = launch_act(a, act, batch, stream);
      if (e == cudaSuccess) e = launch_conv_wgmma(a, act, batch, stream);
      return e;
    }
    // 64-channel chunks where every reduction length allows them
    const bool wide = cin % 64 == 0 && cout % 64 == 0;
    return launch_conv_any<T>(a, batch, wide, stream);
  };
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
  err = conv(c1);
  if (err != cudaSuccess) return err;

  ConvArgs c2 = {};
  c2.src = mid;
  c2.w = w2;
  c2.bias = b2;
  c2.in_partials = partials2;
  c2.in_parts = hw / tile_pixels * (cout / channel_tile);
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
  return conv(c2);
}

}  // namespace

// x: [batch, h, width, cin], w1: [3, 3, cin, cout], w2: [3, 3, cout, cout],
// wskip: [cin, cout] or null (then cin == cout), mid and out: [batch, h,
// width, cout], all contiguous, 16-byte aligned and of one type, fp32
// (is_bf16 = 0) or bf16. The vectors are fp32: gn1_g, gn1_b [cin]; b1,
// gn2_g, gn2_b, b2, bskip [cout]; emb_scale (null selects the additive
// mode) and emb_shift [batch, cout]. route: 0 "scalar" (fp32), 1 "mma" or
// 2 "wgmma" (bf16), with the conv blocks' tile_pixels (whole image rows)
// and channel_tile, which must be the route's own. Scratch: partials1
// [batch, ceil(h * width / 128), groups1, 2] and partials2 [batch, h * width
// / tile_pixels, cout / channel_tile, groups2, 2], fp32; for "wgmma" also
// act [batch, h, width, max(cin, cout)] bf16 (null otherwise). Needs: cin a
// multiple of 32, cout of 64, both at most 1024, at most 32 groups, and
// the route's own conditions (`route_fits`). Returns the cudaError_t of the
// launches (0 on success); a route that does not fit is refused
// (cudaErrorInvalidValue), never replaced by another.
extern "C" int resblock_forward(
    const void* x, const float* gn1_g, const float* gn1_b, const void* w1,
    const float* b1, const float* gn2_g, const float* gn2_b,
    const float* emb_scale, const float* emb_shift, const void* w2,
    const float* b2, const void* wskip, const float* bskip, void* mid,
    void* out, float* partials1, float* partials2, int batch, int h,
    int width, int cin, int cout, int groups1, int groups2, float eps,
    int is_bf16, int route, int tile_pixels, int channel_tile, void* act,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || h <= 0 || cin % 32 || cout % 64 || cin > 1024 ||
      cout > 1024 || groups1 > kMaxGroups || groups2 > kMaxGroups ||
      cin % groups1 || cout % groups2 || batch <= 0 || batch > 65535 ||
      (wskip == nullptr && cin != cout) ||
      !route_fits(route, tile_pixels, channel_tile, h, width, cin, cout,
                  is_bf16 != 0) ||
      (route == kWgmma && act == nullptr))
    return cudaErrorInvalidValue;
  if (is_bf16)
    return launch_resblock<__nv_bfloat16>(
        x, gn1_g, gn1_b, w1, b1, gn2_g, gn2_b, emb_scale, emb_shift, w2, b2,
        wskip, bskip, mid, out, partials1, partials2, batch, h, width, cin,
        cout, groups1, groups2, eps, route, tile_pixels, channel_tile, act,
        s);
  return launch_resblock<float>(
      x, gn1_g, gn1_b, w1, b1, gn2_g, gn2_b, emb_scale, emb_shift, w2, b2,
      wskip, bskip, mid, out, partials1, partials2, batch, h, width, cin, cout,
      groups1, groups2, eps, route, tile_pixels, channel_tile, act, s);
}
