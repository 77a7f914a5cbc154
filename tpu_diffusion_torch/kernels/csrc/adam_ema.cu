// Adam after global-norm clipping, and the EMA blend, for Hopper (sm_90a):
// one pass over every fp32 parameter tensor of a training step.
//
// Replaces no TPU kernel: the JAX package's update is optax's
// (`tpu_diffusion/train/trainer.py:make_optimizer`: clip_by_global_norm,
// scale_by_adam, the schedule) and `tpu_diffusion/core/ema.py`, which XLA
// fuses inside the jitted step. The port ran the same arithmetic as
// fourteen `torch._foreach_*` passes (`train/trainer.py:Optimizer.update`,
// `core/ema.py:ema_blend`), two of which allocated full-size temporaries.
//
// Function, per element of tensor t, with the step's 0-d device scalars lr,
// bc1, bc2 (the bias corrections), the clip factor c = clip / max(norm,
// clip) and the EMA weights d and 1 - d:
//   g' = g * c
//   m  = fma(1 - b1, g', m * b1)
//   v  = fma(1 - b2, g' * g', v * b2)
//   p  = p - ((m / bc1) / (sqrt(v / bc2) + eps)) * lr
//   e  = fma(p, 1 - d, e * d)      where 0 < d < 1
//   e  = p                         where d == 0 (`ema_fill`'s copy)
//   e  untouched, not even read    where d == 1 (`ema_fill`'s "keep")
// each step rounded as written (no other contraction, IEEE division and
// square root). These are the roundings of torch's CUDA ops in the foreach
// body (its alpha= add and addcmul are one fma each, addcmul's product of
// tensors rounded first), so the plain version
// `kernels/adam.py:adam_ema_reference` gives the same bits on the card.
//
// Bound on the H100: bytes. An element reads p, g, m and v and writes p, m
// and v (28 bytes), 36 where the EMA blends, for some 20 operations (three
// divisions and a square root among them): under one operation a byte,
// where the card's fp32 units stop being the limit at about 20. The
// foreach chain moved about 34 tensor sets (12.7 GB at the 64px UNet's
// 93.3M parameters); this pass moves 7, or 9 on a blending step.
//
// Design, for bytes and occupancy:
//   * one launch for all tensors: the wrapper's table holds each tensor's
//     five base pointers ([5, N] int64: p, g, m, v, e; e may be 0) and a
//     chunk list ([C, 3] int64: tensor, start, length; chunks of at most
//     16384 elements, longest first), both in device memory, built once;
//   * a persistent grid (the SMs times the blocks that fit on one) strides
//     over the chunks, so the small tensors (biases, norms) ride along
//     with the large ones and no launch is spent on them;
//   * each thread moves 16 bytes (float4) per stream, where all five base
//     pointers are 16-byte aligned (chunk starts are multiples of four
//     elements), with a scalar tail; a misaligned tensor runs scalar;
//   * thread 0 reads the six device scalars once per block into shared
//     memory; no host value enters, so a captured step replays the launch
//     as it is, and the branch on d is uniform across the block;
//   * no atomics, no allocation: every element is written by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Consts {
  float b1, a1, b2, a2, eps;  // a1 = 1 - b1, a2 = 1 - b2
};

struct Step {
  float lr, bc1, bc2, c, d, r;  // r = 1 - d
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const Step& s,
                                         const Consts& k) {
  const float gc = __fmul_rn(g, s.c);
  m = __fmaf_rn(k.a1, gc, __fmul_rn(m, k.b1));
  v = __fmaf_rn(k.a2, __fmul_rn(gc, gc), __fmul_rn(v, k.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), k.eps);
  p = __fsub_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), s.lr));
}

__device__ __forceinline__ float blend_one(float e, float p, const Step& s) {
  return __fmaf_rn(p, s.r, __fmul_rn(e, s.d));
}

// EMA modes: what a chunk does with e
constexpr int KEEP = 0, BLEND = 1, COPY = 2;

__global__ void __launch_bounds__(THREADS)
adam_ema_kernel(const long long* __restrict__ ptrs, int n_tensors,
                const long long* __restrict__ chunks, int n_chunks,
                const float* __restrict__ lr, const float* __restrict__ bc1,
                const float* __restrict__ bc2, const float* __restrict__ clip,
                const float* __restrict__ decay,
                const float* __restrict__ rest, Consts k) {
  __shared__ Step sh;
  if (threadIdx.x == 0) {
    sh.lr = *lr;
    sh.bc1 = *bc1;
    sh.bc2 = *bc2;
    sh.c = clip ? *clip : 1.f;
    sh.d = decay ? *decay : 1.f;
    sh.r = decay ? *rest : 0.f;
  }
  __syncthreads();
  const Step s = sh;
  const int ema_mode = s.d == 1.f ? KEEP : (s.d == 0.f ? COPY : BLEND);
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const long long t = chunks[3 * ch];
    const long long start = chunks[3 * ch + 1];
    const long long len = chunks[3 * ch + 2];
    float* p = reinterpret_cast<float*>(ptrs[t]) + start;
    const float* g =
        reinterpret_cast<const float*>(ptrs[n_tensors + t]) + start;
    float* m = reinterpret_cast<float*>(ptrs[2 * n_tensors + t]) + start;
    float* v = reinterpret_cast<float*>(ptrs[3 * n_tensors + t]) + start;
    const long long e_base = ptrs[4 * n_tensors + t];
    float* e = e_base ? reinterpret_cast<float*>(e_base) + start : nullptr;
    const int mode = e ? ema_mode : KEEP;
    const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(g) |
                       reinterpret_cast<uintptr_t>(m) |
                       reinterpret_cast<uintptr_t>(v) |
                       reinterpret_cast<uintptr_t>(e)) & 15) == 0;
    const long long n4 = vec ? len / 4 : 0;
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
      float4 pv = reinterpret_cast<const float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      float4 mv = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      float4 ev;
      if (mode == BLEND) ev = reinterpret_cast<const float4*>(e)[i];
      adam_one(pv.x, gv.x, mv.x, vv.x, s, k);
      adam_one(pv.y, gv.y, mv.y, vv.y, s, k);
      adam_one(pv.z, gv.z, mv.z, vv.z, s, k);
      adam_one(pv.w, gv.w, mv.w, vv.w, s, k);
      reinterpret_cast<float4*>(p)[i] = pv;
      reinterpret_cast<float4*>(m)[i] = mv;
      reinterpret_cast<float4*>(v)[i] = vv;
      if (mode == BLEND) {
        ev.x = blend_one(ev.x, pv.x, s);
        ev.y = blend_one(ev.y, pv.y, s);
        ev.z = blend_one(ev.z, pv.z, s);
        ev.w = blend_one(ev.w, pv.w, s);
        reinterpret_cast<float4*>(e)[i] = ev;
      } else if (mode == COPY) {
        reinterpret_cast<float4*>(e)[i] = pv;
      }
    }
    for (long long i = 4 * n4 + threadIdx.x; i < len; i += THREADS) {
      float pi = p[i], mi = m[i], vi = v[i];
      adam_one(pi, g[i], mi, vi, s, k);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
      if (mode == BLEND) {
        e[i] = blend_one(e[i], pi, s);
      } else if (mode == COPY) {
        e[i] = pi;
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;
int grid_of[MAX_DEVICES];  // the persistent grid per device, 0 until known

}  // namespace

// One launch over the tables `ptrs` ([5, n_tensors] int64) and `chunks`
// ([n_chunks, 3] int64), both device memory. `clip` (the clip factor) and
// `decay` with `rest` (the EMA weights) may be null: no clipping, no EMA.
extern "C" int adam_ema(const void* ptrs, int n_tensors, const void* chunks,
                        int n_chunks, const float* lr, const float* bc1,
                        const float* bc2, const float* clip,
                        const float* decay, const float* rest, float b1,
                        float a1, float b2, float a2, float eps,
                        void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_ema_kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_of[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = n_chunks < grid_of[dev] ? n_chunks : grid_of[dev];
  adam_ema_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptrs), n_tensors,
      static_cast<const long long*>(chunks), n_chunks, lr, bc1, bc2, clip,
      decay, rest, Consts{b1, a1, b2, a2, eps});
  return static_cast<int>(cudaGetLastError());
}

// The id of the capture under way on `stream`, 0 where none is.
extern "C" unsigned long long adam_ema_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return 0;
  }
  return id;
}

// Copy `bytes` of pinned host memory to the device on `stream`. Inside a
// stream capture this is a memcpy node, which every replay runs again.
extern "C" int adam_ema_upload(void* dst, const void* src, long long bytes,
                               void* stream) {
  return static_cast<int>(cudaMemcpyAsync(dst, src, bytes,
                                          cudaMemcpyHostToDevice,
                                          static_cast<cudaStream_t>(stream)));
}
