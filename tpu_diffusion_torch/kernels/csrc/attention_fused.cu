// Fused-QKV self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of tpu_diffusion/kernels/attention.py:
// `_fused_kernel_call` (bodies `_attn_fused_kernel`, `_attn_fused_kernel_1ref`,
// `_attn_fused_body`), the Pallas kernel behind `flash_attention_fused`.
//
// Function: for every batch b and head h, softmax(q k^T * d^-1/2) v, read
// straight from the raw [B, T, 3C] qkv projection (channel (s*H + h)*d + i
// for s in {q, k, v}) and written to channels [h*d, (h+1)*d) of [B, T, C].
// No head is transposed to [B, H, T, d] in device memory: the strided head
// slices are read where they lie. Logits are fp32; any T; d in {32, 64, 128}.
//
// Bound on the H100: at the UNet's shape (qkv [64, 256, 768] bf16, 4 heads,
// d = 64) the function moves 33.5 MB (10.0 us at 3.35 TB/s) and does 4.3
// GFLOP (4.3 us at the bf16 tensor-core rate): it is bound by bytes, and a
// call's whole qkv (25 MB) fits the 50 MB L2.
//
// Design, bf16 (`attention_fused_mma_kernel`, the body is
// `tdt::attention_fwd_block` of attention_mma.cuh): one block per (128 query
// rows, head, batch), 8 warps of 16 rows. Both products run on the tensor
// cores (`mma.sync` m16n8k16, fragments by `ldmatrix`); p is handed from the
// s accumulators to the p.v product in registers. K and V stay bf16 in
// shared memory, row-major (V's fragments come through `ldmatrix.trans`),
// staged by `cp.async` in tiles of 64 keys, one commit group per tile, into
// a ring of four slots: at T <= 256 a head's whole K and V are requested at
// once and the first s product starts while later keys are in flight; a
// longer T refills the slots as they are consumed (online softmax, any T).
// Two blocks (92 KB of shared memory each) are resident per SM, 512 blocks
// at the UNet's shape. The softmax runs in base 2 with log2(e) * d^-1/2
// folded into one multiply-add per logit; only the last key tile is masked;
// rows past T compute and store nothing; the output leaves as 16-byte
// stores into the head's channel slice.
//
// fp32 inputs (not on the UNet's path) take the scalar kernel
// (`attention_fused_kernel`): one block per (64-row query tile, head,
// batch), 4 threads per query row holding its scaled q in registers, K and
// V tiles of 32 rows staged as fp32, products as fp32 FMAs on the CUDA
// cores, the same online softmax.
//
// Rounding: the TPU kernel normalises p over the whole row, rounds it to
// v's type and then multiplies by v. The bf16 kernel rounds the
// unnormalised p (<= 1) to bf16 for the p.v product, accumulates in fp32
// and divides by the fp32 row sum at the end, so its output differs from
// the TPU kernel's by the rounding of p (2^-9 relative per term) and the
// output's own rounding; its logits are exact bf16 products summed in fp32,
// scaled after the product. The fp32 kernel keeps p in fp32: exact up to
// summation order.

#include <math.h>

#include "attention_mma.cuh"

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

// bf16 on the tensor cores: one block per (WARPS * 16 query rows, head,
// batch) around `tdt::attention_fwd_block`.
template <int D, int WARPS, int STAGES>
__global__ void __launch_bounds__(WARPS * 32, D <= 64 ? 2 : 1)
attention_fused_mma_kernel(const tdt::bf16* __restrict__ qkv,
                           tdt::bf16* __restrict__ out, int seq, int heads,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long C = static_cast<long long>(heads) * D;
  const long long tok0 = static_cast<long long>(blockIdx.z) * seq;
  const tdt::bf16* q = qkv + tok0 * 3 * C + blockIdx.y * D;  // the head's row 0
  tdt::attention_fwd_block<D, WARPS, STAGES>(
      q, q + C, q + 2 * C, 3 * C, out + tok0 * C + blockIdx.y * D, C, nullptr,
      blockIdx.x * WARPS * 16, seq, scale,
      reinterpret_cast<tdt::bf16*>(smem_raw));
}

// bf16 inputs take the tensor-core kernel, fp32 inputs the scalar kernel.
template <int D>
cudaError_t launch(const void* qkv, void* out, int batch, int seq, int heads,
                   float scale, bool bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr int WARPS = 8;
    // D = 128: two slots of 64 keys (104 KB with the query rows; four
    // would take 174 KB)
    constexpr int STAGES = D == 128 ? 2 : 4;
    constexpr auto kern = attention_fused_mma_kernel<D, WARPS, STAGES>;
    constexpr size_t bytes = tdt::fwd_smem_bytes<D, WARPS, STAGES>();
    const cudaError_t err = tdt::allow_smem<kern>(bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + WARPS * 16 - 1) / (WARPS * 16), heads, batch);
    kern<<<grid, WARPS * 32, bytes, stream>>>(
        static_cast<const tdt::bf16*>(qkv), static_cast<tdt::bf16*>(out), seq,
        heads, scale);
  } else {
    const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
    attention_fused_kernel<float, D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), seq, heads,
        scale);
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
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 32: return launch<32>(qkv, out, batch, seq, heads, scale, bf16, s);
    case 64: return launch<64>(qkv, out, batch, seq, heads, scale, bf16, s);
    case 128: return launch<128>(qkv, out, batch, seq, heads, scale, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
