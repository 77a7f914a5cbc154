// Fused-QKV self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of tpu_diffusion/kernels/attention.py:
// `_fused_kernel_call` (body `_attn_fused_body`), the Pallas kernel behind
// `flash_attention_fused`.
//
// Function: for every batch b and head h, softmax(q k^T * d^-1/2) v, read
// straight from the raw [B, T, 3C] qkv projection (channel (s*H + h)*d + i
// for s in {q, k, v}) and written to channels [h*d, (h+1)*d) of [B, T, C].
// No head is transposed to [B, H, T, d] in device memory: the strided head
// slices are read where they lie.
//
// Bound on the H100: at the UNet's shapes (T = 256, C = 256, d = 64) the
// least time is set by bytes (read 3C, write C per token: 8 MB per batch
// of 16 images in bf16) rather than the 4*T*T*d*H operations per image at
// the tensor-core rate. This first version does its products with scalar
// fp32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor cores' 989), so
// in practice it is bound by operations; `mma.sync` / `wgmma` tiles are
// later work.
//
// Design: one block per (64-row query tile, head, batch), 4 threads per
// query row. Each thread keeps its row's scaled q in registers. Key and
// value tiles of 32 rows are staged in shared memory as fp32, filled with
// 16-byte vector loads of the head's K and V slices. An online softmax
// (running max and running sum, fp32) walks the key tiles, so any T works
// and the T x T logits never reach device memory. Keys past T are masked
// and their V rows zeroed; query rows past T compute and store nothing.
//
// Rounding: the TPU kernel normalises p over the whole row, rounds it to
// v's type and then multiplies by v. Here p stays fp32, p.v accumulates in
// fp32 and the row sum divides once at the end, so the outputs differ at
// the rounding level of the output type (exact in fp32 up to summation
// order).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 32;   // keys per staged tile
constexpr int kLanes = 4;   // threads per query row
constexpr int kThreads = kRows * kLanes;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fused_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                       int seq, int heads, float scale) {
  constexpr int VEC = tdt::vec16<T>();
  constexpr int DP = D + 4;          // padded fp32 row: conflict-free float4
  constexpr int KPL = kKeys / kLanes;  // keys per thread per tile
  constexpr int CHUNKS = D / (4 * kLanes);  // float4 output chunks per thread
  __shared__ __align__(16) float ks[kKeys][DP];
  __shared__ __align__(16) float vs[kKeys][DP];
  __shared__ float ps[kRows][kKeys + 1];

  const int tid = threadIdx.x;
  const int r = tid / kLanes;
  const int g = tid % kLanes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRows + r;
  const int C = heads * D;
  const long long C3 = 3LL * C;
  const T* base = qkv + static_cast<long long>(b) * seq * C3;

  float q[D];
  if (row < seq) {
    const T* qp = base + row * C3 + h * D;
#pragma unroll
    for (int i = 0; i < D; i += VEC) tdt::load16(qp + i, q + i);
#pragma unroll
    for (int i = 0; i < D; ++i) q[i] *= scale;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) q[i] = 0.f;
  }
  float o[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) o[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  constexpr int VPR = D / VEC;  // 16-byte vectors per K (or V) row
  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kKeys * VPR; idx += kThreads) {
      const int j = idx / VPR;
      const int c = (idx % VPR) * VEC;
      float kv[VEC], vv[VEC];
      if (k0 + j < seq) {
        const T* rp = base + (k0 + j) * C3 + h * D + c;
        tdt::load16(rp + C, kv);
        tdt::load16(rp + 2 * C, vv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[j][c + i] = kv[i];
        vs[j][c + i] = vv[i];
      }
    }
    __syncthreads();

    float s[KPL];
    float tmax = -INFINITY;
#pragma unroll
    for (int n = 0; n < KPL; ++n) {
      const int j = g + kLanes * n;
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 kk = kr[i];
        acc = fmaf(q[4 * i], kk.x, acc);
        acc = fmaf(q[4 * i + 1], kk.y, acc);
        acc = fmaf(q[4 * i + 2], kk.z, acc);
        acc = fmaf(q[4 * i + 3], kk.w, acc);
      }
      s[n] = (k0 + j < seq) ? acc : -INFINITY;
      tmax = fmaxf(tmax, s[n]);
    }
    // the 4 lanes of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mnew = fmaxf(m, tmax);  // finite: key k0 < seq is valid
    const float alpha = expf(m - mnew);  // 0 on the first tile
    m = mnew;
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < KPL; ++n) {
      const float p = expf(s[n] - mnew);
      ps[r][g + kLanes * n] = p;
      psum += p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < 4 * CHUNKS; ++i) o[i] *= alpha;
    __syncwarp();  // a row's p is written and read by the same warp

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float p = ps[r][j];
#pragma unroll
      for (int cc = 0; cc < CHUNKS; ++cc) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][(g + kLanes * cc) * 4]);
        o[4 * cc] = fmaf(p, vv.x, o[4 * cc]);
        o[4 * cc + 1] = fmaf(p, vv.y, o[4 * cc + 1]);
        o[4 * cc + 2] = fmaf(p, vv.z, o[4 * cc + 2]);
        o[4 * cc + 3] = fmaf(p, vv.w, o[4 * cc + 3]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row < seq) {
    const float inv = 1.f / l;
    T* op = out + (static_cast<long long>(b) * seq + row) * C + h * D;
#pragma unroll
    for (int cc = 0; cc < CHUNKS; ++cc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        op[(g + kLanes * cc) * 4 + e] = tdt::from_f<T>(o[4 * cc + e] * inv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int batch, int seq, int heads,
                   int head_dim, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  const T* in = static_cast<const T*>(qkv);
  T* o = static_cast<T*>(out);
  switch (head_dim) {
    case 32:
      attention_fused_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          in, o, seq, heads, scale);
      break;
    case 64:
      attention_fused_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          in, o, seq, heads, scale);
      break;
    case 128:
      attention_fused_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          in, o, seq, heads, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// qkv: [batch, seq, 3 * heads * head_dim], out: [batch, seq, heads * head_dim],
// both contiguous and 16-byte aligned, of fp32 (is_bf16 = 0) or bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int attention_fused(const void* qkv, void* out, int batch, int seq,
                               int heads, int head_dim, float scale,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(qkv, out, batch, seq, heads, head_dim, scale,
                                 s);
  }
  return launch<float>(qkv, out, batch, seq, heads, head_dim, scale, s);
}
