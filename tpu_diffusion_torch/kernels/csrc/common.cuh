// Helpers shared by the kernels in this directory: fp32 widening of bf16 and
// fp32 values, bf16 packing, 16-byte vector loads and stores, shared-memory
// addresses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec16() { return 16 / static_cast<int>(sizeof(T)); }

// Read vec16<T>() elements from a 16-byte aligned address, widened to fp32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec16<T>(); ++i) dst[i] = to_f(v[i]);
}

// Write vec16<T>() fp32 values, rounded to T, to a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* src) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec16<T>(); ++i) v[i] = from_f<T>(src[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Two fp32 values rounded to bf16, packed low-first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The shared-state-space address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace tdt
