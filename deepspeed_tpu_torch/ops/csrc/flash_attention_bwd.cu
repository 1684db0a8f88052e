// FlashAttention-2 backward (dq; dk/dv), for Hopper.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel. Same function: from q, k, v, the
// output gradient dO, the forward's per-row log-sum-exp and
// delta = rowsum(dO * O) (computed by the caller, with the lse cotangent
// already folded in), recompute s = scale * q k^T [causal, masked edges] and
// p = exp(s - lse) (a row whose lse is -inf attended nothing: it uses lse 0),
// then
//   dp = dO v^T,   ds = bf16(p * (dp - delta) * scale),
//   dq = ds k,     dk_h = ds^T q,   dv_h = bf16(p)^T dO,
// bf16 operands with fp32 accumulators and the two bf16 rounding points of
// the TPU kernel (ds before its products, p before dv's). dk/dv are per
// *query* head (B, H, Tk, D); the caller sums them over the GQA group.
//
// Layout (the JAX one): q, dO, dq (B, H, T, D); k, v (B, Hkv, Tk, D); dk_h,
// dv_h (B, H, Tk, D), all bf16, 16-byte aligned; lse, delta (B, H, T) fp32.
// D is 64 or 128.
//
// What bounds it on the H100: the 7 * T * Tk * D multiply-add operations
// per head of the two kernels (halved by causality) against the tensor-core
// peak; at gpt2-large's training shape (B4 H20 T1024 D64) that is 0.038 ms,
// against 0.022 ms for the bytes. The products run on the tensor cores with
// warp-level mma.sync (m16n8k16 bf16 -> fp32), operands staged in shared
// memory and read with ldmatrix (transposed where the contraction runs down
// the rows); wgmma, TMA and a software pipeline are later work.
//
// Design: 128 threads (4 warps) a block, each warp 16 rows of the block's
// 64-row tile. dq: one block per (b, h, 64-row q tile); K and V stream
// through shared memory in 64-row tiles (tiles past the causal diagonal are
// never loaded); per tile each warp computes its 16 x 64 scores and dp in
// registers, forms ds there and feeds it straight back as the A operand of
// dq += ds K. dk/dv: one block per (b, h, 64-row kv tile); Q, dO, lse and
// delta stream through shared memory (32-row tiles at D=128 to bound the
// registers, 64 at D=64), starting at the first q tile that reaches the kv
// tile when causal; each warp forms p^T and ds^T for its 16 kv rows and
// accumulates dv += p^T dO and dk += ds^T q. Every output element is written
// by one block and every sum runs in a fixed order: no atomics, two calls
// give bitwise-equal outputs.

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows of the block's own tile (q for dq, kv for dk/dv)

using namespace ds_mma;

__device__ __forceinline__ float lse_or_zero(float l) {
  return isfinite(l) ? l : 0.f;  // -inf: the row attended nothing
}

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * kRows * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int T, int Tk, float scale,
                    int causal) {
  constexpr int kLd = D + 8;
  constexpr int kBk = 64;  // keys per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kRows x kLd
  bf16* dos = qs + kRows * kLd;                   // kRows x kLd
  bf16* ks = dos + kRows * kLd;                   // kBk x kLd
  bf16* vs = ks + kBk * kLd;                      // kBk x kLd

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int kvh = h / (H / Hkv);
  const size_t qoff = (size_t)(b * H + h) * T;
  const bf16* kb = k + (size_t)(b * Hkv + kvh) * Tk * D;
  const bf16* vb = v + (size_t)(b * Hkv + kvh) * Tk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, kRows>(qs, q + qoff * D, q0, T);
  load_rows<D, kRows>(dos, dout + qoff * D, q0, T);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_lo + 8 * i;
    lse_r[i] = r < T ? lse_or_zero(lse[qoff + r]) : 0.f;
    delta_r[i] = r < T ? delta[qoff + r] : 0.f;
  }

  float acc[D / 8][4];
  zero(acc);

  int n_tiles = (Tk + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows + kBk - 1) / kBk);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBk;
    __syncthreads();  // q/dO staged, or the previous tile's readers done
    load_rows<D, kBk>(ks, kb, k0, Tk);
    load_rows<D, kBk>(vs, vb, k0, Tk);
    __syncthreads();

    float s[kBk / 8][4], dp[kBk / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, kBk>(s, qs + warp * 16 * kLd, kLd, ks, kLd, lane);
    mma_abt<D, kBk>(dp, dos + warp * 16 * kLd, kLd, vs, kLd, lane);
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + (e >> 1) * 8, col = k0 + nt * 8 + tig2 + (e & 1);
        const bool ok = col < Tk && (!causal || col <= row);
        const float p = ok ? expf(s[nt][e] * scale - lse_r[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * scale;  // ds
      }
    }
    uint32_t dsf[kBk / 16][4];
    to_a_frags<kBk>(dsf, s);
    mma_rb<kBk, D>(acc, dsf, ks, kLd, lane);
  }

  store_rows<D>(dq + qoff * D, acc, row_lo, T, lane);
}

template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  return D == 128 ? 32 : 64;  // q rows per streamed tile
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kRows + 2 * dkv_q_rows<D>()) * (D + 8) * static_cast<int>(sizeof(bf16)) +
         2 * dkv_q_rows<D>() * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int T, int Tk,
                     float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kBq = dkv_q_rows<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kRows x kLd
  bf16* vs = ks + kRows * kLd;                    // kRows x kLd
  bf16* qs = vs + kRows * kLd;                    // kBq x kLd
  bf16* dos = qs + kBq * kLd;                     // kBq x kLd
  float* lses = reinterpret_cast<float*>(dos + kBq * kLd);
  float* deltas = lses + kBq;

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int kvh = h / (H / Hkv);
  const size_t qoff = (size_t)(b * H + h) * T;
  const bf16* qb = q + qoff * D;
  const bf16* dob = dout + qoff * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_lo = k0 + warp * 16 + lane / 4;  // this lane's kv rows: kv_lo, kv_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, kRows>(ks, k + (size_t)(b * Hkv + kvh) * Tk * D, k0, Tk);
  load_rows<D, kRows>(vs, v + (size_t)(b * Hkv + kvh) * Tk * D, k0, Tk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int n_q = (T + kBq - 1) / kBq;
  const int start_q = causal ? k0 / kBq : 0;

  for (int it = start_q; it < n_q; ++it) {
    const int q0 = it * kBq;
    __syncthreads();  // k/v staged, or the previous tile's readers done
    load_rows<D, kBq>(qs, qb, q0, T);
    load_rows<D, kBq>(dos, dob, q0, T);
    if (threadIdx.x < kBq) {
      const int qp = q0 + threadIdx.x;
      lses[threadIdx.x] = qp < T ? lse_or_zero(lse[qoff + qp]) : 0.f;
      deltas[threadIdx.x] = qp < T ? delta[qoff + qp] : 0.f;
    }
    __syncthreads();

    float st[kBq / 8][4], dpt[kBq / 8][4];  // s^T, dp^T: this warp's 16 kv rows x kBq
    zero(st);
    zero(dpt);
    mma_abt<D, kBq>(st, ks + warp * 16 * kLd, kLd, qs, kLd, lane);
    mma_abt<D, kBq>(dpt, vs + warp * 16 * kLd, kLd, dos, kLd, lane);
#pragma unroll
    for (int nt = 0; nt < kBq / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = kv_lo + (e >> 1) * 8, ci = nt * 8 + tig2 + (e & 1), qpos = q0 + ci;
        const bool ok = qpos < T && kv < Tk && (!causal || kv <= qpos);
        const float p = ok ? expf(st[nt][e] * scale - lses[ci]) : 0.f;
        dpt[nt][e] = p * (dpt[nt][e] - deltas[ci]) * scale;  // ds^T
        st[nt][e] = p;
      }
    }
    uint32_t pf[kBq / 16][4], dsf[kBq / 16][4];
    to_a_frags<kBq>(pf, st);
    to_a_frags<kBq>(dsf, dpt);
    mma_rb<kBq, D>(dv_acc, pf, dos, kLd, lane);
    mma_rb<kBq, D>(dk_acc, dsf, qs, kLd, lane);
  }

  const size_t out = (size_t)(b * H + h) * Tk * D;
  store_rows<D>(dk + out, dk_acc, kv_lo, Tk, lane);
  store_rows<D>(dv + out, dv_acc, kv_lo, Tk, lane);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Hkv, int T, int Tk, float scale,
              int causal, cudaStream_t s) {
  const int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hkv, T, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Hkv, int T, int Tk,
               float scale, int causal, cudaStream_t s) {
  const int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, T,
      Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128} and H % Hkv == 0. Each
// returns cudaGetLastError() (or the error of the shared-memory attribute
// call).
DS_EXPORT int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, int B, int H,
                                  int Hkv, int T, int Tk, int D, float scale, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

DS_EXPORT int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int H, int Hkv, int T, int Tk, int D, float scale, int causal,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
