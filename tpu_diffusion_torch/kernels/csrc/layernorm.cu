// LayerNorm over the last axis for Hopper (sm_90a): one pass that reads the
// rows in their own type, keeps fp32 statistics in registers and writes the
// result in the same type.
//
// Replaces no TPU kernel: the JAX package runs no latent-diffusion UNet.
// It was added for the Stable Diffusion 2 UNet's transformer blocks
// (`models/ldm_unet.py:LayerNorm32`, three a block, 16 blocks a step),
// whose plain version, `F.layer_norm(x.float(), ...).to(x.dtype)`, is three
// kernels: a bf16 -> fp32 cast, an fp32 LayerNorm and an fp32 -> bf16 cast,
// 20 bytes an element.
//
// Function, per row r of x [rows, C], with fp32 weight w and bias b [C]:
//   mean = sum_c x[r, c] / C
//   var  = sum_c (x[r, c] - mean)^2 / C          (centred, from registers)
//   y[r, c] = (x[r, c] - mean) * rsqrt(var + eps) * w[c] + b[c]
// all in fp32, rounded once, at the store, to x's type (bf16 or fp32).
//
// Bound on the H100: bytes. An element is read once and written once (4
// bytes in bf16) for about 6 fp32 operations; w and b are read once a
// row from L1. A step of the SD2 UNet at 8 rows moves 1.11 GB through its
// 48 LayerNorms: 0.331 ms at 3.35 TB/s, against 5.5 GB for the plain
// version.
//
// Design, for bytes in flight:
//   * one warp a row, R rows a warp (2 where a lane holds at most two
//     16-byte vectors of a row, so that short rows still keep enough loads
//     in flight; else 1), WARPS warps a block (a group of lanes a row,
//     sized so that each lane holds five vectors at every SD2 width, was
//     9% slower over a step's 48 calls on the H100);
//   * each lane holds its vectors of the row in registers (16-byte loads,
//     V of them at most: C % 8 == 0 and C <= 2048), so x is read once;
//   * the two sums are warp-shuffle trees in a fixed order, and every
//     element is written by one lane: no atomics, the same bits every call;
//   * no shared memory, no allocation; the launch is on the caller's stream.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // warps of a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CHANNELS = 2048;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// R rows a warp, V 16-byte vectors a lane at most.
template <typename T, int R, int V>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  long long rows, int c, float eps) {
  constexpr int E = tdt::vec16<T>();
  const int lane = threadIdx.x % 32;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32) * R;
  if (row0 >= rows) return;  // uniform across the warp
  const int nvec = c / E;
  const float fc = static_cast<float>(c);
  float v[R][V][E];
  float mean[R], rstd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= rows) continue;
    const T* xr = x + (row0 + r) * c;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = lane + 32 * i;
      if (j < nvec) tdt::load16(xr + j * E, v[r][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= rows) break;  // uniform across the warp
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) s += v[r][i][e];
      }
    }
    mean[r] = warp_sum(s) / fc;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          v[r][i][e] -= mean[r];
          q = fmaf(v[r][i][e], v[r][i][e], q);
        }
      }
    }
    rstd[r] = rsqrtf(warp_sum(q) / fc + eps);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + 32 * i;
    if (j >= nvec) continue;
    float wv[E], bv[E];
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + j * E + k);
      const float4 b4 = *reinterpret_cast<const float4*>(b + j * E + k);
      wv[k] = w4.x, wv[k + 1] = w4.y, wv[k + 2] = w4.z, wv[k + 3] = w4.w;
      bv[k] = b4.x, bv[k + 1] = b4.y, bv[k + 2] = b4.z, bv[k + 3] = b4.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= rows) continue;
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = fmaf(v[r][i][e] * rstd[r], wv[e], bv[e]);
      }
      tdt::store16(y + (row0 + r) * c + j * E, o);
    }
  }
}

template <typename T, int R, int V>
cudaError_t launch(const void* x, const float* w, const float* b, void* y,
                   long long rows, int c, float eps, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(WARPS) * R;
  const long long grid = (rows + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  layer_norm_kernel<T, R, V><<<static_cast<unsigned>(grid), THREADS, 0,
                               stream>>>(static_cast<const T*>(x), w, b,
                                         static_cast<T*>(y), rows, c, eps);
  return cudaGetLastError();
}

// The kernel whose V is the vectors a lane needs for a row of C channels.
template <typename T, int V = 1>
cudaError_t dispatch(int need, const void* x, const float* w, const float* b,
                     void* y, long long rows, int c, float eps,
                     cudaStream_t stream) {
  constexpr int MAX_V = MAX_CHANNELS / tdt::vec16<T>() / 32;
  if constexpr (V > MAX_V) {
    return cudaErrorInvalidValue;
  } else {
    if (need == V) {
      constexpr int R = V <= 2 ? 2 : 1;
      return launch<T, R, V>(x, w, b, y, rows, c, eps, stream);
    }
    return dispatch<T, V + 1>(need, x, w, b, y, rows, c, eps, stream);
  }
}

}  // namespace

// y = LayerNorm(x) over the last axis of x [rows, c], contiguous, bf16
// (`bf16` != 0) or fp32, with fp32 weight and bias [c]; every pointer
// 16-byte aligned, c % 8 == 0 and 0 < c <= 2048 (the wrapper checks).
extern "C" int layer_norm(const void* x, const float* w, const float* b,
                          void* y, long long rows, int c, float eps,
                          int bf16, void* stream) {
  if (c <= 0 || c % 8 || c > MAX_CHANNELS || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int need = (c / tdt::vec16<__nv_bfloat16>() + 31) / 32;
    return static_cast<int>(
        dispatch<__nv_bfloat16>(need, x, w, b, y, rows, c, eps, s));
  }
  const int need = (c / tdt::vec16<float>() + 31) / 32;
  return static_cast<int>(dispatch<float>(need, x, w, b, y, rows, c, eps, s));
}
