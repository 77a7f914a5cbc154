// GroupNorm(+FiLM)+SiLU for Hopper (sm_90a), forward and backward.
//
// The forward replaces the TPU kernel of tpu_diffusion/kernels/groupnorm.py:
// `fused_groupnorm_silu` (body `_gn_silu_kernel`).
//
// Function, on NHWC x [B, HW, C] with G groups of C/G adjacent channels:
//   mean, var = fp32 statistics of each (image, group),
//               var = max(E[x^2] - mean^2, 0)
//   a = rstd * gamma * (1 + scale),  b = (beta - mean * rstd * gamma)
//                                         * (1 + scale) + shift
//   y = silu(x * a + b)   (or x * a + b for act="none"), in x's type.
// scale/shift are per (image, channel) FiLM terms, absent for plain
// GroupNorm.
//
// Bound on the H100: bytes. The function reads x once and writes y once
// and does about ten operations per element (the accurate SiLU some
// twenty more), far under the ~295 operations per byte at which the card
// stops being bound by its memory.
//
// Two routes, picked by the caller (`gn_route` in kernels/groupnorm.py);
// the entry points refuse a geometry they cannot run.
//
// "cluster" (`gn_cluster_kernel`, one launch, every shape of the CIFAR
// UNet): the TPU kernel kept a whole image in VMEM; here a thread block
// cluster of 1, 2, 4 or 8 blocks shares one image, each block holding its
// hw / cluster pixels (at most 192 KB) in shared memory from the one read
// of x to the one write of y:
//   1. one thread asks for the chunk in four `cp.async.bulk` copies, each
//      completing an mbarrier; meanwhile every thread reads its channels'
//      gamma, beta and FiLM terms;
//   2. each thread sums its fixed vector of channels (16-byte reads along C)
//      over its pixels in fp32, piece by piece as the copies land, folds
//      them into at most two groups, and one warp per group adds the
//      block's entries in a fixed order and a shuffle tree;
//   3. the blocks exchange their per-group sums through distributed shared
//      memory: one `barrier.cluster` arrive/wait, then every block adds all
//      of them in rank order, so all blocks (and two calls) get the same
//      bits; a second arrive says it is done reading the others, and its
//      wait ends the kernel, so that no block leaves while another may
//      still read its shared memory;
//   4. each thread folds mean, rstd, gamma, beta and FiLM into a, b for its
//      channels exactly as the two-pass route does and streams its pixels
//      from shared memory: y = silu(x a + b) (the accurate `expf` and
//      division, the plain version's rounding), 16-byte stores.
//   The cluster size is chosen for the fewest waves of blocks over the
//   card's SMs (at batch 64, where the chunk fits, a single wave of 128
//   blocks, two per image); what bounds it then is the serial chain
//   of each block (load, reduce, cluster barrier, apply and store, with no
//   other block to overlap on its SM) and, for the largest images, two
//   waves; for the 4x4 and 8x8 images it is the ~7 us of that chain.
// "two_pass" (`gn_stats_kernel`, `gn_apply_kernel`, images too large for
// eight blocks): both passes over (pixel chunk, image) blocks in which each
// thread owns a fixed run of channels:
//   1. stats: per-channel fp32 sums over the chunk's pixels, folded into
//      per-group partial sums [B, chunks, G, 2] (no atomics, so the result
//      does not depend on block order);
//   2. apply: the block reduces its image's partials to mean and rstd,
//      folds gamma, beta and FiLM into per-channel a and b in registers,
//      and streams its chunk once: load, y = x*a + b, SiLU, store.
//   x is read twice; the second read finds it in the 50 MB L2 whenever the
//   tensor fits there.
// Backward (no TPU counterpart: the JAX kernel has none; added so that the
// trained UNet can take the kernel pair instead of the plain chain's fp32
// copies, layout copies and casts). The forward writes each (image,
// group)'s mean and rstd when given a pointer; the backward recomputes z
// from x and them, so it saves neither the output nor an fp32 copy. Bound
// on the H100: bytes (read x and dy, write dx); about 25 operations per
// element. Routes, picked by `gn_bwd_route`:
// "cluster" (`gn_bwd_cluster_kernel`, images whose x and dy are at most
// 256 KB): a cluster of 1-8 blocks per image holds x and dy in shared
// memory from their one read to the one write of dx, the per-channel sums
// exchanged through distributed shared memory;
// "two_pass" (`gn_bwd_sums_kernel`, `gn_bwd_reduce_kernel`,
// `gn_bwd_dx_kernel`): per-chunk sums, a per-image reduction, dx; x and dy
// are read twice. Both end with `gn_bwd_params_kernel`, which sums dgamma
// and dbeta over the batch in order.
// Trap: the bulk copies write shared memory through the async proxy; the
// mbarriers must be initialised and fenced (`fence.mbarrier_init`) before
// the copies are issued, and a thread reads a piece only after its
// mbarrier's phase has completed.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x,
                                float2* __restrict__ partials, int hw, int C,
                                int G, int pix_per_chunk, int nchunk) {
  constexpr int VEC = tdt::vec16<T>();
  extern __shared__ float red[];  // [2][rows][C]
  const int CV = C / VEC;
  const int rows = blockDim.x / CV;
  const int tid = threadIdx.x;
  const int cv = tid % CV;
  const int rr = tid / CV;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = chunk * pix_per_chunk;
  const int p1 = min(hw, p0 + pix_per_chunk);

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  const T* xb = x + static_cast<long long>(b) * hw * C + cv * VEC;
  for (int p = p0 + rr; p < p1; p += rows) {
    float v[VEC];
    tdt::load16(xb + static_cast<long long>(p) * C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
  float* r1 = red;
  float* r2 = red + rows * C;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    r1[rr * C + cv * VEC + i] = s1[i];
    r2[rr * C + cv * VEC + i] = s2[i];
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = tid; g < G; g += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < rows; ++q) {
      for (int c = g * cg; c < (g + 1) * cg; ++c) {
        a1 += r1[q * C + c];
        a2 += r2[q * C + c];
      }
    }
    partials[(static_cast<long long>(b) * nchunk + chunk) * G + g] =
        make_float2(a1, a2);
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const T* __restrict__ scale,
                                const T* __restrict__ shift, int film_stride,
                                float2* __restrict__ stats,
                                const float2* __restrict__ partials, int hw,
                                int C, int G, int pix_per_chunk, int nchunk,
                                float eps, int silu) {
  constexpr int VEC = tdt::vec16<T>();
  extern __shared__ float st[];  // mean[G], rstd[G]
  float* mean_s = st;
  float* rstd_s = st + G;
  const int CV = C / VEC;
  const int rows = blockDim.x / CV;
  const int tid = threadIdx.x;
  const int cv = tid % CV;
  const int rr = tid / CV;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = C / G;

  const float n = static_cast<float>(hw) * static_cast<float>(cg);
  for (int g = tid; g < G; g += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < nchunk; ++k) {
      const float2 pr = partials[(static_cast<long long>(b) * nchunk + k) * G + g];
      a1 += pr.x;
      a2 += pr.y;
    }
    const float mean = a1 / n;
    const float var = fmaxf(a2 / n - mean * mean, 0.f);
    mean_s[g] = mean;
    rstd_s[g] = rsqrtf(var + eps);
    if (stats != nullptr && chunk == 0)
      stats[static_cast<long long>(b) * G + g] = make_float2(mean, rstd_s[g]);
  }
  __syncthreads();

  float a[VEC], bb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = cv * VEC + i;
    const int g = c / cg;
    a[i] = rstd_s[g] * gamma[c];
    bb[i] = beta[c] - mean_s[g] * a[i];
    if (scale != nullptr) {
      const long long fi = static_cast<long long>(b) * film_stride + c;
      const float sc = 1.f + tdt::to_f(scale[fi]);
      a[i] *= sc;
      bb[i] = bb[i] * sc + tdt::to_f(shift[fi]);
    }
  }

  const int p0 = chunk * pix_per_chunk;
  const int p1 = min(hw, p0 + pix_per_chunk);
  const long long off = static_cast<long long>(b) * hw * C + cv * VEC;
  for (int p = p0 + rr; p < p1; p += rows) {
    const long long e = off + static_cast<long long>(p) * C;
    float v[VEC];
    tdt::load16(x + e, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float t = fmaf(v[i], a[i], bb[i]);
      v[i] = silu ? t / (1.f + expf(-t)) : t;
    }
    tdt::store16(y + e, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* gamma,
                   const float* beta, const void* scale, const void* shift,
                   int film_stride, void* stats, void* partials, int batch,
                   int hw, int C, int G, int rows, int pix_per_chunk,
                   int nchunk, float eps, int silu, cudaStream_t stream) {
  constexpr int VEC = tdt::vec16<T>();
  const int threads = (C / VEC) * rows;
  const dim3 grid(nchunk, batch);
  gn_stats_kernel<T><<<grid, threads, 2 * rows * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(partials), hw, C, G,
      pix_per_chunk, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, threads, 2 * G * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), gamma, beta,
      static_cast<const T*>(scale), static_cast<const T*>(shift), film_stride,
      static_cast<float2*>(stats), static_cast<const float2*>(partials), hw,
      C, G, pix_per_chunk, nchunk, eps, silu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One launch per call: a cluster of `cluster` blocks per image (one block
// for a small image), each holding its share of the image's pixels in
// shared memory from the one read of x to the one write of y.
// ---------------------------------------------------------------------------

constexpr int kPieces = 4;  // bulk copies (each with its mbarrier) per chunk
constexpr int kClusterSmemMax = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(512)
gn_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, const T* __restrict__ scale,
                  const T* __restrict__ shift, int film_stride,
                  float2* __restrict__ stats, int hw, int C, int G, int rows,
                  float eps, int silu) {
  constexpr int VEC = tdt::vec16<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = hw / nblk;  // this block's pixels
  const int CV = C / VEC;
  const int tid = threadIdx.x, cv = tid % CV, rr = tid / CV;
  const int b = blockIdx.y;
  const int cg_ = C / G;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [P][C], the chunk of x
  // [threads] this thread's sums for the first and the second group its
  // channels touch
  float4* red = reinterpret_cast<float4*>(xs + static_cast<size_t>(P) * C);
  float2* part = reinterpret_cast<float2*>(red + blockDim.x);  // [G]
  float2* stat = part + G;  // [G] mean, rstd
  uint64_t* bars = reinterpret_cast<uint64_t*>(stat + G);  // [kPieces]
  const int pieces = min(kPieces, P);
  const long long pix0 = static_cast<long long>(b) * hw +
                         static_cast<long long>(rank) * P;

  if (tid == 0) {
    for (int i = 0; i < pieces; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < pieces; ++i) {
      const int pa = P * i / pieces, pb = P * (i + 1) / pieces;
      const int bytes = (pb - pa) * C * static_cast<int>(sizeof(T));
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bars + i)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(xs + pa * C)),
          "l"(x + (pix0 + pa) * C), "r"(bytes), "r"(smem_u32(bars + i))
          : "memory");
    }
  }
  // this thread's channels' gamma, beta, 1 + scale and shift, read while
  // the copies are in flight
  float gm[VEC], bt[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = cv * VEC + k;
    gm[k] = gamma[c];
    bt[k] = beta[c];
    sc[k] = 1.f;
    sh[k] = 0.f;
    if (scale != nullptr) {
      const long long fi = static_cast<long long>(b) * film_stride + c;
      sc[k] = 1.f + tdt::to_f(scale[fi]);
      sh[k] = tdt::to_f(shift[fi]);
    }
  }
  __syncthreads();  // the barriers are initialised

  // per-channel fp32 sums over this thread's pixels, piece by piece as the
  // copies land
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (int i = 0; i < pieces; ++i) {
    const int pa = P * i / pieces, pb = P * (i + 1) / pieces;
    const uint32_t bar = smem_u32(bars + i);
    for (int spins = 0;; ++spins) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar)
          : "memory");
      if (done) break;
      if (spins > (1 << 22)) __trap();
    }
    for (int p = pa + ((rr - pa) % rows + rows) % rows; p < pb; p += rows) {
      float v[VEC];
      tdt::load16(xs + p * C + cv * VEC, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s1[k] += v[k];
        s2[k] = fmaf(v[k], v[k], s2[k]);
      }
    }
  }
  const int g0 = cv * VEC / cg_;  // the first group of this thread's channels
  float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if ((cv * VEC + k) / cg_ == g0) {
      mine.x += s1[k];
      mine.y += s2[k];
    } else {
      mine.z += s1[k];
      mine.w += s2[k];
    }
  }
  red[tid] = mine;
  __syncthreads();
  // per-group sums of the block: one warp per group, each lane over a fixed
  // stride of the (row, vector) entries that touch the group, then a
  // shuffle tree
  const int lane = tid % 32, nwarps = blockDim.x / 32;
  for (int g = tid / 32; g < G; g += nwarps) {
    const int cv0 = g * cg_ / VEC, ncv = ((g + 1) * cg_ - 1) / VEC - cv0 + 1;
    float a1 = 0.f, a2 = 0.f;
    for (int e = lane; e < rows * ncv; e += 32) {
      const int v = cv0 + e % ncv;
      const float4 r = red[e / ncv * CV + v];
      const bool first = v * VEC / cg_ == g;
      a1 += first ? r.x : r.z;
      a2 += first ? r.y : r.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) part[g] = make_float2(a1, a2);
  }
  // every block's partial sums are written; each block adds all of them in
  // rank order, so every block (and every call) gets the same statistics
  cluster_arrive();
  cluster_wait();
  if (tid < G) {
    float a1 = 0.f, a2 = 0.f;
    for (int r = 0; r < nblk; ++r) {
      const float2 pr = *cluster.map_shared_rank(part + tid, r);
      a1 += pr.x;
      a2 += pr.y;
    }
    const float cnt = static_cast<float>(hw) * static_cast<float>(cg_);
    const float mean = a1 / cnt;
    const float var = fmaxf(a2 / cnt - mean * mean, 0.f);
    stat[tid] = make_float2(mean, rsqrtf(var + eps));
    if (stats != nullptr && rank == 0)
      stats[static_cast<long long>(b) * G + tid] = stat[tid];
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();   // stat is written

  // the two-pass route's arithmetic: a = rstd * gamma * (1 + scale),
  // b = (beta - mean * rstd * gamma) * (1 + scale) + shift
  float a[VEC], bb[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float2 st = stat[(cv * VEC + k) / cg_];
    a[k] = st.y * gm[k];
    bb[k] = bt[k] - st.x * a[k];
    if (scale != nullptr) {
      a[k] *= sc[k];
      bb[k] = bb[k] * sc[k] + sh[k];
    }
  }
  T* yb = y + pix0 * C + cv * VEC;
  for (int p = rr; p < P; p += rows) {
    float v[VEC];
    tdt::load16(xs + p * C + cv * VEC, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float t = fmaf(v[k], a[k], bb[k]);
      v[k] = silu ? t / (1.f + expf(-t)) : t;
    }
    tdt::store16(yb + static_cast<long long>(p) * C, v);
  }
  cluster_wait();  // no block leaves while another may still read it
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* y, const float* gamma,
                           const float* beta, const void* scale,
                           const void* shift, int film_stride, void* stats,
                           int batch, int hw, int C, int G, int cluster,
                           int rows, float eps, int silu,
                           cudaStream_t stream) {
  constexpr int VEC = tdt::vec16<T>();
  const int threads = (C / VEC) * rows;
  if (C % VEC || G < 1 || C % G || G > threads ||
      !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) ||
      hw % cluster || rows < 1 || threads % 32 || threads > 512 ||
      batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  // a thread's VEC channels may touch at most two groups
  for (int cv = 0; cv < C / VEC; ++cv)
    if ((cv * VEC + VEC - 1) / (C / G) - cv * VEC / (C / G) > 1)
      return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(hw / cluster) * C * sizeof(T) +
                       threads * sizeof(float4) + 2 * G * sizeof(float2) +
                       kPieces * sizeof(uint64_t);
  if (bytes > kClusterSmemMax) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kClusterSmemMax);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel<T>, static_cast<const T*>(x), static_cast<T*>(y),
      gamma, beta, static_cast<const T*>(scale), static_cast<const T*>(shift),
      film_stride, static_cast<float2*>(stats), hw, C, G, rows, eps, silu);
}

// ---------------------------------------------------------------------------
// Backward. With x^ = (x - mean) * rstd, z = (x^ gamma + beta)(1 + scale) +
// shift and y = act(z), dz = dy act'(z) is recomputed from x and the
// forward's statistics, and per (image, channel) two sums over the pixels,
//   S1 = sum dz,  S2 = sum dz x^,
// give every gradient:
//   dshift = S1,  dscale = gamma S2 + beta S1,
//   dbeta = sum_b (1 + scale) S1,  dgamma = sum_b (1 + scale) S2,
//   dx = rstd (g - m1 - x^ m2),  g = gamma (1 + scale) dz,
// where m1, m2 are the group means of g and g x^, sums over the group's
// channels of gamma (1 + scale) S1 and gamma (1 + scale) S2 over its
// hw * C / G elements. Nothing uses atomics: the per-(image, channel)
// terms go to a [B, C] scratch that `gn_bwd_params_kernel` sums over the
// batch in order, so two calls give the same bits.
// ---------------------------------------------------------------------------

// SiLU's slope, sigma(z) (1 + z (1 - sigma(z))), with the fast exponential
// and division (a few ulp; -z capped at 80 keeps the divisor finite)
__device__ __forceinline__ float act_grad(float z, int silu) {
  if (!silu) return 1.f;
  const float s = __fdividef(1.f, 1.f + __expf(fminf(-z, 80.f)));
  return s * (1.f + z * (1.f - s));
}

// A backward thread owns 4 channels (8-byte bf16 loads, 16-byte fp32): with
// the forward's 16-byte bf16 vectors of 8 channels its per-channel terms
// took ~120 registers, two blocks an SM, and the passes ran at 1.3-2 TB/s.
constexpr int kBwdVec = 4;

template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = uint4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void unpack4(typename Raw4<T>::type raw,
                                        float* d) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kBwdVec; ++i) d[i] = tdt::to_f(v[i]);
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float* d) {
  unpack4<T>(*reinterpret_cast<const typename Raw4<T>::type*>(p), d);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float* src) {
  typename Raw4<T>::type raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kBwdVec; ++i) v[i] = tdt::from_f<T>(src[i]);
  *reinterpret_cast<typename Raw4<T>::type*>(p) = raw;
}

// A thread's 4 channels of image b, folded: x^ = x r + rb (rb = -mean r),
// z = x^ a + bz (a = gamma (1 + scale), bz = beta (1 + scale) + shift).
template <typename T>
struct BwdChannels {
  float r[kBwdVec], rb[kBwdVec], a[kBwdVec], bz[kBwdVec];

  __device__ __forceinline__ BwdChannels(const float* gamma,
                                         const float* beta, const T* scale,
                                         const T* shift, int film_stride,
                                         const float2* stats, int b, int c0,
                                         int cg, int G) {
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const int c = c0 + k;
      float sc = 1.f, sh = 0.f;
      if (scale != nullptr) {
        const long long fi = static_cast<long long>(b) * film_stride + c;
        sc = 1.f + tdt::to_f(scale[fi]);
        sh = tdt::to_f(shift[fi]);
      }
      const float2 st = stats[static_cast<long long>(b) * G + c / cg];
      r[k] = st.y;
      rb[k] = -st.x * st.y;
      a[k] = gamma[c] * sc;
      bz[k] = fmaf(beta[c], sc, sh);
    }
  }

  // dz and x^ of one vector of x and dy, in place: xv becomes x^, dyv dz
  __device__ __forceinline__ void dz(float* xv, float* dyv, int silu) const {
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      xv[k] = fmaf(xv[k], r[k], rb[k]);
      dyv[k] *= act_grad(fmaf(xv[k], a[k], bz[k]), silu);
    }
  }
};

// dx = rstd (gamma (1 + scale) dz - m1 - x^ m2) = A dz + B + C x^
struct DxTerms {
  float A[kBwdVec], B[kBwdVec], C[kBwdVec];

  template <typename T>
  __device__ __forceinline__ DxTerms(const BwdChannels<T>& ch,
                                     const float2* coef, int c0, int cg) {
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      const float2 m = coef[(c0 + k) / cg];
      A[k] = ch.r[k] * ch.a[k];
      B[k] = -ch.r[k] * m.x;
      C[k] = -ch.r[k] * m.y;
    }
  }

  // xv, dyv: x and dy in, dx out in xv
  template <typename T>
  __device__ __forceinline__ void dx(const BwdChannels<T>& ch, float* xv,
                                     float* dyv, int silu) const {
    ch.dz(xv, dyv, silu);
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k)
      xv[k] = fmaf(A[k], dyv[k], fmaf(C[k], xv[k], B[k]));
  }
};

// The per-(image, channel) gradients from S1, S2: dshift and dscale (FiLM
// only, if `write`), the [B, C] scratch of (1 + scale)(S1, S2) that
// `gn_bwd_params_kernel` sums over the batch (if `write`); returns gamma
// (1 + scale)(S1, S2), the channel's share of its group's m1, m2.
template <typename T>
__device__ __forceinline__ float2 finish_channel(
    int b, int c, int C, float s1, float s2, const float* gamma,
    const float* beta, const T* scale, int film_stride, T* dscale, T* dshift,
    float2* pc, bool write) {
  const float gm = gamma[c];
  float sc = 1.f;
  const long long o = static_cast<long long>(b) * C + c;
  if (scale != nullptr) {
    sc = 1.f + tdt::to_f(scale[static_cast<long long>(b) * film_stride + c]);
    if (write) {
      dshift[o] = tdt::from_f<T>(s1);
      dscale[o] = tdt::from_f<T>(fmaf(gm, s2, beta[c] * s1));
    }
  }
  if (write) pc[o] = make_float2(sc * s1, sc * s2);
  return make_float2(gm * sc * s1, gm * sc * s2);
}

// A block's per-channel sums: each thread's 4 channels over its pixels go
// to red [2][rows][C]; thread c adds channel c's rows in order.
__device__ __forceinline__ float2 block_channel_sum(const float* red,
                                                    int rows, int C, int c) {
  float a1 = 0.f, a2 = 0.f;
  for (int q = 0; q < rows; ++q) {
    a1 += red[q * C + c];
    a2 += red[(rows + q) * C + c];
  }
  return make_float2(a1, a2);
}

// Two-pass route, 1 of 3: S1, S2 of each channel over a chunk of pixels,
// [B, chunks, C] float2.
template <typename T>
__global__ void __launch_bounds__(512)
gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const T* __restrict__ scale, const T* __restrict__ shift,
                   int film_stride, const float2* __restrict__ stats,
                   float2* __restrict__ part, int hw, int C, int G,
                   int pix_per_chunk, int nchunk, int silu) {
  extern __shared__ float red[];  // [2][rows][C]
  const int CV = C / kBwdVec;
  const int rows = blockDim.x / CV;
  const int tid = threadIdx.x, cv = tid % CV, rr = tid / CV;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const BwdChannels<T> ch(gamma, beta, scale, shift, film_stride, stats, b,
                          cv * kBwdVec, C / G, G);
  float s1[kBwdVec], s2[kBwdVec];
#pragma unroll
  for (int k = 0; k < kBwdVec; ++k) s1[k] = s2[k] = 0.f;
  const int p0 = chunk * pix_per_chunk;
  const int p1 = min(hw, p0 + pix_per_chunk);
  const long long off = static_cast<long long>(b) * hw * C + cv * kBwdVec;
#pragma unroll 4
  for (int p = p0 + rr; p < p1; p += rows) {
    const long long e = off + static_cast<long long>(p) * C;
    float xv[kBwdVec], dv[kBwdVec];
    load4(x + e, xv);
    load4(dy + e, dv);
    ch.dz(xv, dv, silu);
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      s1[k] += dv[k];
      s2[k] = fmaf(dv[k], xv[k], s2[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdVec; ++k) {
    red[rr * C + cv * kBwdVec + k] = s1[k];
    red[(rows + rr) * C + cv * kBwdVec + k] = s2[k];
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x)
    part[(static_cast<long long>(b) * nchunk + chunk) * C + c] =
        block_channel_sum(red, rows, C, c);
}

// Two-pass route, 2 of 3: one block per image adds its chunks' sums in
// order, writes the per-channel gradients and its groups' m1, m2.
template <typename T>
__global__ void gn_bwd_reduce_kernel(const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     const T* __restrict__ scale,
                                     int film_stride,
                                     const float2* __restrict__ part,
                                     int nchunk, int hw, int C, int G,
                                     T* __restrict__ dscale,
                                     T* __restrict__ dshift,
                                     float2* __restrict__ pc,
                                     float2* __restrict__ coef) {
  extern __shared__ float2 gs[];  // [C] gamma (1 + scale)(S1, S2)
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < nchunk; ++k) {
      const float2 pr = part[(static_cast<long long>(b) * nchunk + k) * C + c];
      a1 += pr.x;
      a2 += pr.y;
    }
    gs[c] = finish_channel<T>(b, c, C, a1, a2, gamma, beta, scale,
                              film_stride, dscale, dshift, pc, true);
  }
  __syncthreads();
  const int cg = C / G;
  const float n = static_cast<float>(hw) * static_cast<float>(cg);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      m1 += gs[c].x;
      m2 += gs[c].y;
    }
    coef[static_cast<long long>(b) * G + g] = make_float2(m1 / n, m2 / n);
  }
}

// Two-pass route, 3 of 3: dx over the same (chunk, image) blocks.
template <typename T>
__global__ void __launch_bounds__(512)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 T* __restrict__ dx, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ scale,
                 const T* __restrict__ shift, int film_stride,
                 const float2* __restrict__ stats,
                 const float2* __restrict__ coef, int hw, int C, int G,
                 int pix_per_chunk, int silu) {
  const int CV = C / kBwdVec;
  const int rows = blockDim.x / CV;
  const int tid = threadIdx.x, cv = tid % CV, rr = tid / CV;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const BwdChannels<T> ch(gamma, beta, scale, shift, film_stride, stats, b,
                          cv * kBwdVec, cg, G);
  const DxTerms dt(ch, coef + static_cast<long long>(b) * G, cv * kBwdVec,
                   cg);
  const int p0 = chunk * pix_per_chunk;
  const int p1 = min(hw, p0 + pix_per_chunk);
  const long long off = static_cast<long long>(b) * hw * C + cv * kBwdVec;
#pragma unroll 4
  for (int p = p0 + rr; p < p1; p += rows) {
    const long long e = off + static_cast<long long>(p) * C;
    float xv[kBwdVec], dv[kBwdVec];
    load4(x + e, xv);
    load4(dy + e, dv);
    dt.dx(ch, xv, dv, silu);
    store4(dx + e, xv);
  }
}

// Both routes, last: dgamma and dbeta, the scratch summed over the batch
// in order.
__global__ void gn_bwd_params_kernel(const float2* __restrict__ pc,
                                     int batch, int C,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a1 = 0.f, a2 = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float2 v = pc[static_cast<long long>(b) * C + c];
    a1 += v.x;
    a2 += v.y;
  }
  dbeta[c] = a1;
  dgamma[c] = a2;
}

// Cluster route: a cluster of `cluster` blocks per image, each holding its
// hw / cluster pixels of x and dy in shared memory from the one read of
// each to the one write of dx. Each block sums S1, S2 over its pixels per
// channel; the blocks exchange them through distributed shared memory and
// every block adds all of them in rank order (rank 0 writes the
// per-channel gradients), then streams dx from shared memory.
template <typename T>
__global__ void __launch_bounds__(512)
gn_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      T* __restrict__ dx, const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const T* __restrict__ scale,
                      const T* __restrict__ shift, int film_stride,
                      const float2* __restrict__ stats,
                      T* __restrict__ dscale, T* __restrict__ dshift,
                      float2* __restrict__ pc, int hw, int C, int G,
                      int silu) {
  using Raw = typename Raw4<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = hw / nblk;
  const int CV = C / kBwdVec;
  const int rows = blockDim.x / CV;
  const int tid = threadIdx.x, cv = tid % CV, rr = tid / CV;
  const int b = blockIdx.y;
  const int cg_ = C / G;
  extern __shared__ __align__(16) unsigned char bsmem[];
  T* xs = reinterpret_cast<T*>(bsmem);               // [P][C]
  T* ds = xs + static_cast<size_t>(P) * C;           // [P][C]
  float* red = reinterpret_cast<float*>(ds + static_cast<size_t>(P) * C);
  float2* part = reinterpret_cast<float2*>(red + 2 * rows * C);  // [C]
  float2* coef = part + C;                                         // [G]
  const BwdChannels<T> ch(gamma, beta, scale, shift, film_stride, stats, b,
                          cv * kBwdVec, cg_, G);
  const long long pix0 = static_cast<long long>(b) * hw +
                         static_cast<long long>(rank) * P;

  // one read of x and dy: kept in shared memory, summed on the way
  float s1[kBwdVec], s2[kBwdVec];
#pragma unroll
  for (int k = 0; k < kBwdVec; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll 4
  for (int p = rr; p < P; p += rows) {
    const long long e = (pix0 + p) * C + cv * kBwdVec;
    const int l = p * C + cv * kBwdVec;
    const Raw xr = *reinterpret_cast<const Raw*>(x + e);
    const Raw dr = *reinterpret_cast<const Raw*>(dy + e);
    *reinterpret_cast<Raw*>(xs + l) = xr;
    *reinterpret_cast<Raw*>(ds + l) = dr;
    float xv[kBwdVec], dv[kBwdVec];
    unpack4<T>(xr, xv);
    unpack4<T>(dr, dv);
    ch.dz(xv, dv, silu);
#pragma unroll
    for (int k = 0; k < kBwdVec; ++k) {
      s1[k] += dv[k];
      s2[k] = fmaf(dv[k], xv[k], s2[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdVec; ++k) {
    red[rr * C + cv * kBwdVec + k] = s1[k];
    red[(rows + rr) * C + cv * kBwdVec + k] = s2[k];
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x)
    part[c] = block_channel_sum(red, rows, C, c);
  // every block's sums are written; each adds all of them in rank order
  cluster_arrive();
  cluster_wait();
  float2* gs = reinterpret_cast<float2*>(red);  // [C]; red is read
  for (int c = tid; c < C; c += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int r = 0; r < nblk; ++r) {
      const float2 pr = *cluster.map_shared_rank(part + c, r);
      a1 += pr.x;
      a2 += pr.y;
    }
    gs[c] = finish_channel<T>(b, c, C, a1, a2, gamma, beta, scale,
                              film_stride, dscale, dshift, pc, rank == 0);
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();   // gs is written
  const float n = static_cast<float>(hw) * static_cast<float>(cg_);
  for (int g = tid; g < G; g += blockDim.x) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = g * cg_; c < (g + 1) * cg_; ++c) {
      m1 += gs[c].x;
      m2 += gs[c].y;
    }
    coef[g] = make_float2(m1 / n, m2 / n);
  }
  __syncthreads();
  const DxTerms dt(ch, coef, cv * kBwdVec, cg_);
  T* dxb = dx + pix0 * C + cv * kBwdVec;
#pragma unroll 4
  for (int p = rr; p < P; p += rows) {
    float xv[kBwdVec], dv[kBwdVec];
    load4(xs + p * C + cv * kBwdVec, xv);
    load4(ds + p * C + cv * kBwdVec, dv);
    dt.dx(ch, xv, dv, silu);
    store4(dxb + static_cast<long long>(p) * C, xv);
  }
  cluster_wait();  // no block leaves while another may still read it
}

cudaError_t launch_params(const void* pc, int batch, int C, float* dgamma,
                          float* dbeta, cudaStream_t stream) {
  gn_bwd_params_kernel<<<(C + 255) / 256, 256, 0, stream>>>(
      static_cast<const float2*>(pc), batch, C, dgamma, dbeta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, void* dx,
                       const float* gamma, const float* beta,
                       const void* scale, const void* shift, int film_stride,
                       const void* stats, void* dscale, void* dshift,
                       void* pc, float* dgamma, float* dbeta, void* part,
                       void* coef, int batch, int hw, int C, int G, int rows,
                       int pix_per_chunk, int nchunk, int silu,
                       cudaStream_t stream) {
  const int threads = (C / kBwdVec) * rows;
  if (C % kBwdVec || G < 1 || C % G || rows < 1 || threads > 512 ||
      batch < 1 || batch > 65535 || nchunk < 1 ||
      static_cast<long long>(nchunk) * pix_per_chunk < hw)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* sc = static_cast<const T*>(scale);
  const T* sh = static_cast<const T*>(shift);
  const float2* st = static_cast<const float2*>(stats);
  const dim3 grid(nchunk, batch);
  gn_bwd_sums_kernel<T><<<grid, threads, 2 * rows * C * sizeof(float),
                          stream>>>(xt, dyt, gamma, beta, sc, sh, film_stride,
                                    st, static_cast<float2*>(part), hw, C, G,
                                    pix_per_chunk, nchunk, silu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_reduce_kernel<T><<<batch, 512, C * sizeof(float2), stream>>>(
      gamma, beta, sc, film_stride, static_cast<const float2*>(part), nchunk,
      hw, C, G, static_cast<T*>(dscale), static_cast<T*>(dshift),
      static_cast<float2*>(pc), static_cast<float2*>(coef));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_dx_kernel<T><<<grid, threads, 0, stream>>>(
      xt, dyt, static_cast<T*>(dx), gamma, beta, sc, sh, film_stride, st,
      static_cast<const float2*>(coef), hw, C, G, pix_per_chunk, silu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_params(pc, batch, C, dgamma, dbeta, stream);
}

template <typename T>
cudaError_t launch_bwd_cluster(const void* x, const void* dy, void* dx,
                               const float* gamma, const float* beta,
                               const void* scale, const void* shift,
                               int film_stride, const void* stats,
                               void* dscale, void* dshift, void* pc,
                               float* dgamma, float* dbeta, int batch, int hw,
                               int C, int G, int cluster, int rows, int silu,
                               cudaStream_t stream) {
  const int threads = (C / kBwdVec) * rows;
  if (C % kBwdVec || G < 1 || C % G || rows < 1 || threads > 512 ||
      !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) ||
      hw % cluster || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const size_t bytes = 2 * static_cast<size_t>(hw / cluster) * C * sizeof(T) +
                       2 * static_cast<size_t>(rows) * C * sizeof(float) +
                       (static_cast<size_t>(C) + G) * sizeof(float2);
  if (bytes > kClusterSmemMax) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_bwd_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kClusterSmemMax);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_bwd_cluster_kernel<T>, static_cast<const T*>(x),
      static_cast<const T*>(dy), static_cast<T*>(dx), gamma, beta,
      static_cast<const T*>(scale), static_cast<const T*>(shift), film_stride,
      static_cast<const float2*>(stats), static_cast<T*>(dscale),
      static_cast<T*>(dshift), static_cast<float2*>(pc), hw, C, G, silu);
  if (err != cudaSuccess) return err;
  return launch_params(pc, batch, C, dgamma, dbeta, stream);
}

}  // namespace

// x, y: [batch, hw, C] contiguous, 16-byte aligned, fp32 (is_bf16 = 0) or
// bf16; gamma, beta: [C] fp32; scale, shift: rows of `film_stride` elements
// of x's type, or both null; stats: [batch, G] float2 (mean, rstd) written
// for the backward, or null; partials: [batch, nchunk, G] float2 scratch.
// The block has (C / vec) * rows threads, vec = 16 / sizeof(element), and
// covers pix_per_chunk pixels. Returns the cudaError_t of the launches.
extern "C" int groupnorm_silu(const void* x, void* y, const float* gamma,
                              const float* beta, const void* scale,
                              const void* shift, int film_stride, void* stats,
                              void* partials, int batch, int hw, int C, int G,
                              int rows, int pix_per_chunk, int nchunk,
                              float eps, int silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, y, gamma, beta, scale, shift, film_stride,
                                 stats, partials, batch, hw, C, G, rows,
                                 pix_per_chunk, nchunk, eps, silu, s);
  }
  return launch<float>(x, y, gamma, beta, scale, shift, film_stride, stats,
                       partials, batch, hw, C, G, rows, pix_per_chunk, nchunk,
                       eps, silu, s);
}

// The one-launch route: as above without `partials`; the grid is (cluster,
// batch) in clusters of `cluster` (1, 2, 4 or 8) blocks of (C / vec) * rows
// threads (a multiple of 32, at most 512), each block covering hw / cluster
// pixels of one image in shared memory. A geometry the kernel cannot run
// is refused (cudaErrorInvalidValue).
extern "C" int groupnorm_silu_cluster(const void* x, void* y,
                                      const float* gamma, const float* beta,
                                      const void* scale, const void* shift,
                                      int film_stride, void* stats, int batch,
                                      int hw, int C, int G, int cluster,
                                      int rows, float eps, int silu,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_cluster<__nv_bfloat16>(x, y, gamma, beta, scale, shift,
                                         film_stride, stats, batch, hw, C, G,
                                         cluster, rows, eps, silu, s);
  }
  return launch_cluster<float>(x, y, gamma, beta, scale, shift, film_stride,
                               stats, batch, hw, C, G, cluster, rows, eps,
                               silu, s);
}

// The backward's two-pass route: x, dy, dx as x above; stats: the
// forward's [batch, G] float2; dscale, dshift: [batch, C] of x's type (both
// null without FiLM); pc: [batch, C] float2 scratch; dgamma, dbeta: [C]
// fp32; part: [batch, nchunk, C] float2 and coef: [batch, G] float2
// scratch. Sums, per-image reduction, dx (blocks of (C / 4) * rows threads,
// at most 512, over pix_per_chunk pixels each), then dgamma and dbeta.
extern "C" int groupnorm_silu_bwd(const void* x, const void* dy, void* dx,
                                  const float* gamma, const float* beta,
                                  const void* scale, const void* shift,
                                  int film_stride, const void* stats,
                                  void* dscale, void* dshift, void* pc,
                                  float* dgamma, float* dbeta, void* part,
                                  void* coef, int batch, int hw, int C, int G,
                                  int rows, int pix_per_chunk, int nchunk,
                                  int silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16>(
        x, dy, dx, gamma, beta, scale, shift, film_stride, stats, dscale,
        dshift, pc, dgamma, dbeta, part, coef, batch, hw, C, G, rows,
        pix_per_chunk, nchunk, silu, s);
  }
  return launch_bwd<float>(x, dy, dx, gamma, beta, scale, shift, film_stride,
                           stats, dscale, dshift, pc, dgamma, dbeta, part,
                           coef, batch, hw, C, G, rows, pix_per_chunk, nchunk,
                           silu, s);
}

// The backward's cluster route: as above without `part` and `coef`; the
// grid is (cluster, batch) in clusters of `cluster` blocks of (C / 4) *
// rows threads (at most 512), each holding hw / cluster pixels of x and dy
// in shared memory; then dgamma and dbeta. A geometry the kernel cannot
// run is refused (cudaErrorInvalidValue).
extern "C" int groupnorm_silu_bwd_cluster(
    const void* x, const void* dy, void* dx, const float* gamma,
    const float* beta, const void* scale, const void* shift, int film_stride,
    const void* stats, void* dscale, void* dshift, void* pc, float* dgamma,
    float* dbeta, int batch, int hw, int C, int G, int cluster, int rows,
    int silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bwd_cluster<__nv_bfloat16>(
        x, dy, dx, gamma, beta, scale, shift, film_stride, stats, dscale,
        dshift, pc, dgamma, dbeta, batch, hw, C, G, cluster, rows, silu, s);
  }
  return launch_bwd_cluster<float>(x, dy, dx, gamma, beta, scale, shift,
                                   film_stride, stats, dscale, dshift, pc,
                                   dgamma, dbeta, batch, hw, C, G, cluster,
                                   rows, silu, s);
}
