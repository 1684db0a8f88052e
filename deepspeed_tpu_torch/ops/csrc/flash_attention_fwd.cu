// FlashAttention-2 forward with log-sum-exp, for Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py::_fwd_kernel.
// Same function: softmax(scale * q k^T [causal]) v with an fp32 online
// softmax, GQA-native (query head h reads KV head h / (H / Hkv)), and the
// per-row log-sum-exp; a row that attends nothing gets out = 0, lse = -inf.
//
// Layout (the JAX one): q (B, H, T, D), k/v (B, Hkv, Tk, D) bf16; out
// (B, H, T, D) bf16; lse (B, H, T) fp32. D is 64 or 128.
//
// What bounds it on the H100: at prefill lengths (T = 128..512) the
// 4*T*Tk*D multiply-adds per head (halved by causality) against the
// tensor-core peak; this first version runs them on CUDA cores from shared
// memory, well below that peak (tensor cores, TMA and pipelining are later
// work).
//
// Design: one block per (b, h, 32-row q tile), 128 threads, 4 per query
// row. The TPU kernel keeps the whole KV head in VMEM and walks it in a
// sequential loop; here K and V stream through shared memory in 32-row
// tiles inside the block, tiles past the causal diagonal are never loaded,
// and the T and Tk edges are masked in the kernel (the TPU padded them). The
// 4 threads of a row hold 8 scores each and reduce the row max and sum with
// warp shuffles; each holds D/4 output accumulators in registers.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBq = 32;                 // query rows per block
constexpr int kBk = 32;                 // key rows per tile
constexpr int kTpr = 4;                 // threads per query row
constexpr int kNj = kBk / kTpr;         // scores per thread per tile

template <int D>
constexpr int smem_floats() {
  return kBq * (D + 1) + kBk * (D + 1) + kBk * D + kBq * (kBk + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int T, int Tk, float scale,
                 int causal) {
  constexpr int Dp = D + 1;        // padded rows: conflict-free column reads
  constexpr int Nd = D / kTpr;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                // kBq x Dp
  float* ks = qs + kBq * Dp;       // kBk x Dp
  float* vs = ks + kBk * Dp;       // kBk x D
  float* ps = vs + kBk * D;        // kBq x (kBk + 1)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int kvh = h / (H / Hkv);
  const __nv_bfloat16* qb = q + (size_t)(b * H + h) * T * D;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + kvh) * Tk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + kvh) * Tk * D;

  const int tid = threadIdx.x;
  const int r = tid / kTpr, sub = tid % kTpr;
  const int qpos = q0 + r;

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    qs[rr * Dp + d] = (q0 + rr < T) ? __bfloat162float(qb[(size_t)(q0 + rr) * D + d]) : 0.f;
  }

  float m_i = -INFINITY, l_i = 0.f;
  float acc[Nd];
#pragma unroll
  for (int i = 0; i < Nd; ++i) acc[i] = 0.f;

  int n_tiles = (Tk + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kBq + kBk - 1) / kBk);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBk;
    __syncthreads();  // q staged / previous tile's readers done
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int jj = i / D, d = i % D;
      const bool ok = k0 + jj < Tk;
      ks[jj * Dp + d] = ok ? __bfloat162float(kb[(size_t)(k0 + jj) * D + d]) : 0.f;
      vs[jj * D + d] = ok ? __bfloat162float(vb[(size_t)(k0 + jj) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[kNj];
    unsigned live = 0;
    float m_loc = DS_MASK_VALUE;
#pragma unroll
    for (int t = 0; t < kNj; ++t) {
      const int jj = sub + t * kTpr, kpos = k0 + jj;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qs[r * Dp + d], ks[jj * Dp + d], dot);
      const bool ok = kpos < Tk && (!causal || kpos <= qpos);
      s[t] = ok ? dot * scale : DS_MASK_VALUE;
      live |= ok ? (1u << t) : 0u;
      m_loc = fmaxf(m_loc, s[t]);
    }
    m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
    m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 2));
    const float m_new = fmaxf(m_i, m_loc);
    const float alpha = expf(m_i - m_new);
    float l_loc = 0.f;
#pragma unroll
    for (int t = 0; t < kNj; ++t) {
      const float p = (live >> t & 1u) ? expf(s[t] - m_new) : 0.f;
      ps[r * (kBk + 1) + sub + t * kTpr] = p;
      l_loc += p;
    }
    l_loc += __shfl_xor_sync(0xffffffffu, l_loc, 1);
    l_loc += __shfl_xor_sync(0xffffffffu, l_loc, 2);
    l_i = l_i * alpha + l_loc;
    m_i = m_new;
    __syncwarp();  // the row's 4 threads share one warp: ps row is visible
#pragma unroll
    for (int i = 0; i < Nd; ++i) acc[i] *= alpha;
    for (int jj = 0; jj < kBk; ++jj) {
      const float p = ps[r * (kBk + 1) + jj];
#pragma unroll
      for (int i = 0; i < Nd; ++i) acc[i] = fmaf(p, vs[jj * D + sub + i * kTpr], acc[i]);
    }
  }

  if (qpos < T) {
    const float l_safe = l_i == 0.f ? 1.f : l_i;
    __nv_bfloat16* ob = out + ((size_t)(b * H + h) * T + qpos) * D;
#pragma unroll
    for (int i = 0; i < Nd; ++i) ob[sub + i * kTpr] = __float2bfloat16(acc[i] / l_safe);
    if (sub == 0)
      lse[(size_t)(b * H + h) * T + qpos] = l_i == 0.f ? -INFINITY : m_i + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Hkv, int T, int Tk, float scale, int causal, cudaStream_t s) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBq - 1) / kBq, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, T, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, D in
// {64, 128} and H % Hkv == 0. Returns cudaGetLastError() (or the error of
// the shared-memory attribute call).
DS_EXPORT int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int H, int Hkv, int T, int Tk, int D,
                               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128) return launch<128>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
