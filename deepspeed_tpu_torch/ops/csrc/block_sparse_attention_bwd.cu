// Block-sparse flash attention backward (dq; dk/dv), for Hopper.
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/
// block_sparse_attention.py::_bwd_dq_kernel and ::_bwd_dkv_kernel. Same
// function: from q, k, v, the output gradient dO, the forward's per-row
// log-sum-exp and delta = rowsum(dO * O) (fp32, computed by the caller),
// recompute s = scale * q k^T on the layout's active tiles (causal
// kv_pos <= q_pos, key positions >= T masked, and for dk/dv query
// positions >= T masked) and p = exp(s - lse) (a row whose lse is -inf
// attended nothing: it reads lse 0 and its p stays 0 under the mask), then
//   dp = dO v^T,   ds = bf16(p * (dp - delta) * scale),
//   dq = ds k,     dk = ds^T q,   dv = bf16(p)^T dO,
// bf16 operands with fp32 accumulators and the two bf16 rounding points of
// the TPU kernels (ds before its products, p before dv's).
//
// Layout (the JAX one): q, k, v, dO, dq, dk, dv (B, H, T, D) bf16, 16-byte
// aligned; lse, delta (B, H, T) fp32; dq walks q_idx (H, nq, K) / q_cnt
// (H, nq), dk/dv the transposed kv_idx (H, nk, Kt) / kv_cnt (H, nk), int32.
// D is 64 or 128; block is 16, 32, 64 or 128.
//
// What bounds it on the H100: as for the forward, the bytes at the layouts
// SparsityConfig makes (6 * D operations a visible pair for dq, 8 * D for
// dk/dv, against reading q, k, v, dO, lse and delta once and writing the
// gradients once), and in practice the latency of each table step's tile
// loads. The products run on the tensor cores with warp-level mma.sync
// (ops/csrc/mma_tile.cuh), operands staged in shared memory and read with
// ldmatrix (transposed where the contraction runs down the rows); wgmma,
// TMA, a software pipeline and splitting the long (global) rows and columns
// are later work.
//
// Design: block/16 warps a CTA, each warp 16 rows of the CTA's block. dq:
// one CTA per (b, h, q block); it walks the q block's kv blocks in table
// order, staging K and V of each, and each warp forms its scores, dp and ds
// in registers (in column sub-tiles of at most 64 keys, to bound the
// registers) and feeds ds straight back as the A operand of dq += ds K.
// dk/dv: one CTA per (b, h, kv block); it walks the q blocks that read the
// kv block (the transposed table) in order, staging Q, dO, lse and delta of
// each; each warp forms p^T and ds^T for its 16 kv rows, in query sub-tiles
// of 64 (D = 64) or 32 (D = 128) rows, and accumulates dv += p^T dO and
// dk += ds^T q. The sub-tiles add their products in the same order as one
// pass over the block would. A tile wholly above the diagonal under causal,
// or wholly past T, contributes nothing and is skipped. Every output
// element is written by one CTA, a block no query reads gets dk = dv = 0,
// and every sum runs in table order: no atomics, two calls give
// bitwise-equal outputs.

#include <math.h>

#include "mma_tile.cuh"

namespace {

using namespace ds_mma;

__device__ __forceinline__ float lse_or_zero(float l) {
  return isfinite(l) ? l : 0.f;  // -inf: the row attended nothing
}

template <int BLK, int D>
constexpr int dq_smem_bytes() {
  return 4 * BLK * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int BLK, int D>
__global__ void __launch_bounds__(BLK * 2)
block_sparse_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ idx, const int* __restrict__ cnt,
                       bf16* __restrict__ dq, int H, int T, int nq, int K, float scale,
                       int causal) {
  constexpr int kLd = D + 8;
  constexpr int kKt = BLK < 64 ? BLK : 64;  // keys per register sub-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BLK x kLd
  bf16* dos = qs + BLK * kLd;                     // BLK x kLd
  bf16* ks = dos + BLK * kLd;                     // BLK x kLd
  bf16* vs = ks + BLK * kLd;                      // BLK x kLd

  const int b = blockIdx.z, h = blockIdx.y, qi = blockIdx.x;
  const int q0 = qi * BLK;
  if (q0 >= T) return;
  const size_t base = (size_t)(b * H + h) * T;
  const bf16* kb = k + base * D;
  const bf16* vb = v + base * D;
  const int* row_idx = idx + (size_t)(h * nq + qi) * K;
  const int n = cnt[h * nq + qi];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, BLK>(qs, q + base * D, q0, T);
  load_rows<D, BLK>(dos, dout + base * D, q0, T);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_lo + 8 * i;
    lse_r[i] = r < T ? lse_or_zero(lse[base + r]) : 0.f;
    delta_r[i] = r < T ? delta[base + r] : 0.f;
  }

  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n; ++j) {
    const int k0 = row_idx[j] * BLK;
    if (k0 >= T || (causal && k0 > q0)) continue;  // every entry masked (uniform in the CTA)
    __syncthreads();  // q/dO staged, or the previous block's readers done
    load_rows<D, BLK>(ks, kb, k0, T);
    load_rows<D, BLK>(vs, vb, k0, T);
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < BLK; c0 += kKt) {
      float s[kKt / 8][4], dp[kKt / 8][4];
      zero(s);
      zero(dp);
      mma_abt<D, kKt>(s, qs + warp * 16 * kLd, kLd, ks + c0 * kLd, kLd, lane);
      mma_abt<D, kKt>(dp, dos + warp * 16 * kLd, kLd, vs + c0 * kLd, kLd, lane);
#pragma unroll
      for (int nt = 0; nt < kKt / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_lo + (e >> 1) * 8, col = k0 + c0 + nt * 8 + tig2 + (e & 1);
          const bool ok = col < T && (!causal || col <= row);
          const float p = ok ? expf(s[nt][e] * scale - lse_r[e >> 1]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * scale;  // ds
        }
      }
      uint32_t dsf[kKt / 16][4];
      to_a_frags<kKt>(dsf, s);
      mma_rb<kKt, D>(acc, dsf, ks + c0 * kLd, kLd, lane);
    }
  }

  store_rows<D>(dq + base * D, acc, row_lo, T, lane);
}

template <int BLK, int D>
__host__ __device__ constexpr int dkv_q_rows() {
  return BLK < (D == 128 ? 32 : 64) ? BLK : (D == 128 ? 32 : 64);  // q rows per sub-tile
}

template <int BLK, int D>
constexpr int dkv_smem_bytes() {
  return 4 * BLK * (D + 8) * static_cast<int>(sizeof(bf16)) + 2 * BLK * static_cast<int>(sizeof(float));
}

template <int BLK, int D>
__global__ void __launch_bounds__(BLK * 2)
block_sparse_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ idx, const int* __restrict__ cnt,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int nk, int Kt,
                        float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kQt = dkv_q_rows<BLK, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BLK x kLd
  bf16* vs = ks + BLK * kLd;                      // BLK x kLd
  bf16* qs = vs + BLK * kLd;                      // BLK x kLd
  bf16* dos = qs + BLK * kLd;                     // BLK x kLd
  float* lses = reinterpret_cast<float*>(dos + BLK * kLd);
  float* deltas = lses + BLK;

  const int b = blockIdx.z, h = blockIdx.y, ki = blockIdx.x;
  const int k0 = ki * BLK;
  if (k0 >= T) return;  // a kv block wholly past the sequence: nothing to write
  const size_t base = (size_t)(b * H + h) * T;
  const bf16* qb = q + base * D;
  const bf16* dob = dout + base * D;
  const int* col_idx = idx + (size_t)(h * nk + ki) * Kt;
  const int n = cnt[h * nk + ki];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_lo = k0 + warp * 16 + lane / 4;  // this lane's kv rows: kv_lo, kv_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, BLK>(ks, k + base * D, k0, T);
  load_rows<D, BLK>(vs, v + base * D, k0, T);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n; ++it) {
    const int q0 = col_idx[it] * BLK;
    if (q0 >= T || (causal && k0 > q0)) continue;  // every entry masked (uniform in the CTA)
    __syncthreads();  // k/v staged, or the previous block's readers done
    load_rows<D, BLK>(qs, qb, q0, T);
    load_rows<D, BLK>(dos, dob, q0, T);
    if (threadIdx.x < BLK) {
      const int qp = q0 + threadIdx.x;
      lses[threadIdx.x] = qp < T ? lse_or_zero(lse[base + qp]) : 0.f;
      deltas[threadIdx.x] = qp < T ? delta[base + qp] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < BLK; c0 += kQt) {
      float st[kQt / 8][4], dpt[kQt / 8][4];  // s^T, dp^T: this warp's 16 kv rows x kQt
      zero(st);
      zero(dpt);
      mma_abt<D, kQt>(st, ks + warp * 16 * kLd, kLd, qs + c0 * kLd, kLd, lane);
      mma_abt<D, kQt>(dpt, vs + warp * 16 * kLd, kLd, dos + c0 * kLd, kLd, lane);
#pragma unroll
      for (int nt = 0; nt < kQt / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = kv_lo + (e >> 1) * 8, ci = c0 + nt * 8 + tig2 + (e & 1), qpos = q0 + ci;
          const bool ok = qpos < T && kv < T && (!causal || kv <= qpos);
          const float p = ok ? expf(st[nt][e] * scale - lses[ci]) : 0.f;
          dpt[nt][e] = p * (dpt[nt][e] - deltas[ci]) * scale;  // ds^T
          st[nt][e] = p;
        }
      }
      uint32_t pf[kQt / 16][4], dsf[kQt / 16][4];
      to_a_frags<kQt>(pf, st);
      to_a_frags<kQt>(dsf, dpt);
      mma_rb<kQt, D>(dv_acc, pf, dos + c0 * kLd, kLd, lane);
      mma_rb<kQt, D>(dk_acc, dsf, qs + c0 * kLd, kLd, lane);
    }
  }

  store_rows<D>(dk + base * D, dk_acc, kv_lo, T, lane);
  store_rows<D>(dv + base * D, dv_acc, kv_lo, T, lane);
}

template <int BLK, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* idx, const void* cnt, void* dq, int B, int H, int T,
              int nq, int K, float scale, int causal, cudaStream_t s) {
  const int smem = dq_smem_bytes<BLK, D>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_dq_kernel<BLK, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nq, H, B);
  block_sparse_dq_kernel<BLK, D><<<grid, BLK * 2, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<bf16*>(dq), H, T, nq, K, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BLK, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* idx, const void* cnt, void* dk, void* dv, int B,
               int H, int T, int nk, int Kt, float scale, int causal, cudaStream_t s) {
  const int smem = dkv_smem_bytes<BLK, D>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_dkv_kernel<BLK, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nk, H, B);
  block_sparse_dkv_kernel<BLK, D><<<grid, BLK * 2, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(idx), static_cast<const int*>(cnt),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, nk, Kt, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

#define DS_BLOCKS(F, D, ...)                              \
  switch (block) {                                        \
    case 16: return F<16, D>(__VA_ARGS__);                \
    case 32: return F<32, D>(__VA_ARGS__);                \
    case 64: return F<64, D>(__VA_ARGS__);                \
    case 128: return F<128, D>(__VA_ARGS__);              \
  }                                                       \
  return static_cast<int>(cudaErrorInvalidValue)

template <int D>
int dq_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
         const void* delta, const void* idx, const void* cnt, void* dq, int B, int H, int T,
         int block, int nq, int K, float scale, int causal, cudaStream_t s) {
  DS_BLOCKS(launch_dq, D, q, k, v, dout, lse, delta, idx, cnt, dq, B, H, T, nq, K, scale, causal, s);
}

template <int D>
int dkv_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, const void* idx, const void* cnt, void* dk, void* dv, int B, int H,
          int T, int block, int nk, int Kt, float scale, int causal, cudaStream_t s) {
  DS_BLOCKS(launch_dkv, D, q, k, v, dout, lse, delta, idx, cnt, dk, dv, B, H, T, nk, Kt, scale,
            causal, s);
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128}, block in {16, 32, 64, 128}
// and T <= (number of table rows) * block. Each returns cudaGetLastError()
// (or the error of the shared-memory attribute call).
DS_EXPORT int block_sparse_bwd_dq_launch(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* idx, const void* cnt, void* dq, int B, int H,
                                         int T, int D, int block, int nq, int K, float scale,
                                         int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return dq_d<64>(q, k, v, dout, lse, delta, idx, cnt, dq, B, H, T, block, nq, K, scale, causal, s);
  if (D == 128)
    return dq_d<128>(q, k, v, dout, lse, delta, idx, cnt, dq, B, H, T, block, nq, K, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

DS_EXPORT int block_sparse_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* idx, const void* cnt, void* dk, void* dv,
                                          int B, int H, int T, int D, int block, int nk, int Kt,
                                          float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dkv_d<64>(q, k, v, dout, lse, delta, idx, cnt, dk, dv, B, H, T, block, nk, Kt, scale, causal, s);
  if (D == 128)
    return dkv_d<128>(q, k, v, dout, lse, delta, idx, cnt, dk, dv, B, H, T, block, nk, Kt, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
