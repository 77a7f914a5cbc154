// GroupNorm(+FiLM)+SiLU for Hopper (sm_90a).
//
// Replaces the TPU kernel of tpu_diffusion/kernels/groupnorm.py:
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
                   int film_stride, void* partials, int batch, int hw, int C,
                   int G, int rows, int pix_per_chunk, int nchunk, float eps,
                   int silu, cudaStream_t stream) {
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
      static_cast<const float2*>(partials), hw, C, G, pix_per_chunk, nchunk,
      eps, silu);
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
                  const T* __restrict__ shift, int film_stride, int hw, int C,
                  int G, int rows, float eps, int silu) {
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
                           const void* shift, int film_stride, int batch,
                           int hw, int C, int G, int cluster, int rows,
                           float eps, int silu, cudaStream_t stream) {
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
      film_stride, hw, C, G, rows, eps, silu);
}

}  // namespace

// x, y: [batch, hw, C] contiguous, 16-byte aligned, fp32 (is_bf16 = 0) or
// bf16; gamma, beta: [C] fp32; scale, shift: rows of `film_stride` elements
// of x's type, or both null; partials: [batch, nchunk, G] float2 scratch.
// The block has (C / vec) * rows threads, vec = 16 / sizeof(element), and
// covers pix_per_chunk pixels. Returns the cudaError_t of the launches.
extern "C" int groupnorm_silu(const void* x, void* y, const float* gamma,
                              const float* beta, const void* scale,
                              const void* shift, int film_stride,
                              void* partials, int batch, int hw, int C, int G,
                              int rows, int pix_per_chunk, int nchunk,
                              float eps, int silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, y, gamma, beta, scale, shift, film_stride,
                                 partials, batch, hw, C, G, rows,
                                 pix_per_chunk, nchunk, eps, silu, s);
  }
  return launch<float>(x, y, gamma, beta, scale, shift, film_stride, partials,
                       batch, hw, C, G, rows, pix_per_chunk, nchunk, eps, silu,
                       s);
}

// The one-launch route: as above without `partials`; the grid is (cluster,
// batch) in clusters of `cluster` (1, 2, 4 or 8) blocks of (C / vec) * rows
// threads (a multiple of 32, at most 512), each block covering hw / cluster
// pixels of one image in shared memory. A geometry the kernel cannot run
// is refused (cudaErrorInvalidValue).
extern "C" int groupnorm_silu_cluster(const void* x, void* y,
                                      const float* gamma, const float* beta,
                                      const void* scale, const void* shift,
                                      int film_stride, int batch, int hw,
                                      int C, int G, int cluster, int rows,
                                      float eps, int silu, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_cluster<__nv_bfloat16>(x, y, gamma, beta, scale, shift,
                                         film_stride, batch, hw, C, G,
                                         cluster, rows, eps, silu, s);
  }
  return launch_cluster<float>(x, y, gamma, beta, scale, shift, film_stride,
                               batch, hw, C, G, cluster, rows, eps, silu, s);
}
