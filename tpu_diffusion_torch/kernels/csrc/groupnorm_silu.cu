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
// and does about ten operations per element, far under the ~295 operations
// per byte at which the card stops being bound by its memory.
//
// Design: the TPU kernel kept a whole image in 16 MB of VMEM; a Hopper
// block has at most 227 KB of shared memory, and one block per image would
// leave most of the 132 SMs idle at small batch. So there are two passes,
// both over (pixel chunk, image) blocks in which each thread owns a fixed
// run of channels (16-byte loads along C, adjacent threads on adjacent
// addresses):
//   1. stats: per-channel fp32 sums over the chunk's pixels, folded into
//      per-group partial sums [B, chunks, G, 2] (no atomics, so the result
//      does not depend on block order);
//   2. apply: the block reduces its image's partials to mean and rstd,
//      folds gamma, beta and FiLM into per-channel a and b in registers,
//      and streams its chunk once: load, y = x*a + b, SiLU, store.
// x is read twice; the second read finds it in the 50 MB L2 whenever the
// tensor fits there, which every tensor of the CIFAR UNet at batch 64 does.

#include <math.h>

#include "common.cuh"

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
