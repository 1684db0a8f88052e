// Block-sparse flash attention forward with log-sum-exp, for Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/sparse_attention/
// block_sparse_attention.py::_fwd_kernel. Same function: for each query
// block qi of head h, softmax(scale * q k^T) v over only the kv blocks
// idx[h, qi, 0 .. cnt[h, qi]) of a static block layout, in table order,
// with an fp32 online softmax whose state is updated once per kv block; in
// a tile the causal mask is kv_pos <= q_pos and key positions >= T are
// masked. As in the TPU kernel, the probabilities are rounded to bf16 before
// the P V product and the row sums take them unrounded, and a row whose
// every visited entry is masked (or whose count is 0) gets out = 0 and
// lse = -inf.
//
// Layout (the JAX one): q, k, v, out (B, H, T, D) bf16, 16-byte aligned;
// lse (B, H, T) fp32; idx (H, nq, K) and cnt (H, nq) int32, T <= nq * block.
// D is 64 or 128; block is 16, 32, 64 or 128.
//
// What bounds it on the H100: the bytes, at the layouts SparsityConfig
// makes. A q block reads each active kv block once, so the operations are
// 4 * D per visible (q, k) pair, and at gpt2-large's widths (B2 H20 T4096
// D64, block 64, BigBird) the pairs number ~9% of the dense square: about
// 0.02 ms of tensor-core work against ~0.025 ms for reading q, k, v and
// writing out once. The kv blocks a q block visits are read again by the
// other q blocks that visit them (from L2, where the layout keeps them
// near), so the time goes to the table walk's latency: each block waits
// for its K and V tile. The products run on the tensor cores with
// warp-level mma.sync (ops/csrc/mma_tile.cuh); wgmma, TMA, a software
// pipeline, and splitting the global rows (which visit every kv block while
// the others visit about five) are later work.
//
// Design: one block of block/16 warps per (b, h, q block); each warp owns
// 16 query rows. The CTA reads its count and walks the index table: per
// active kv block it stages that block's K and V rows in shared memory
// (rows past T as zeros), each warp computes its 16 x block scores in
// registers, masks them, updates its rows' running max and sum, and feeds
// the probabilities straight from the score accumulators into the A
// operand of P V. A kv block that lies wholly above the diagonal under
// causal, or wholly past T, changes nothing (every entry masked: p = 0) and
// is skipped. Rows past T are neither written nor stored.

#include <math.h>

#include "mma_tile.cuh"

namespace {

using namespace ds_mma;

template <int BLK, int D>
constexpr int smem_bytes() {
  return 3 * BLK * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int BLK, int D>
__global__ void __launch_bounds__(BLK * 2)
block_sparse_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ idx,
                        const int* __restrict__ cnt, bf16* __restrict__ out,
                        float* __restrict__ lse, int H, int T, int nq, int K, float scale,
                        int causal) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BLK x kLd
  bf16* ks = qs + BLK * kLd;                      // BLK x kLd
  bf16* vs = ks + BLK * kLd;                      // BLK x kLd

  const int b = blockIdx.z, h = blockIdx.y, qi = blockIdx.x;
  const int q0 = qi * BLK;
  if (q0 >= T) return;  // a q block wholly past the sequence: nothing to write
  const size_t base = (size_t)(b * H + h) * T;
  const bf16* kb = k + base * D;
  const bf16* vb = v + base * D;
  const int* row_idx = idx + (size_t)(h * nq + qi) * K;
  const int n = cnt[h * nq + qi];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, BLK>(qs, q + base * D, q0, T);

  // m: running max of each row (uniform over the row's 4 lanes); l: this
  // lane's share of the row's running sum, reduced over the 4 lanes at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n; ++j) {
    const int k0 = row_idx[j] * BLK;
    if (k0 >= T || (causal && k0 > q0)) continue;  // every entry masked (uniform in the CTA)
    __syncthreads();  // q staged, or the previous block's readers done
    load_rows<D, BLK>(ks, kb, k0, T);
    load_rows<D, BLK>(vs, vb, k0, T);
    __syncthreads();

    float s[BLK / 8][4];
    zero(s);
    mma_abt<D, BLK>(s, qs + warp * 16 * kLd, kLd, ks, kLd, lane);
    float mx[2] = {DS_MASK_VALUE, DS_MASK_VALUE};
#pragma unroll
    for (int nt = 0; nt < BLK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + (e >> 1) * 8, col = k0 + nt * 8 + tig2 + (e & 1);
        const bool ok = col < T && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] * scale : DS_MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < BLK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + (e >> 1) * 8, col = k0 + nt * 8 + tig2 + (e & 1);
        const bool ok = col < T && (!causal || col <= row);
        const float p = ok ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    uint32_t pf[BLK / 16][4];
    to_a_frags<BLK>(pf, s);
    mma_rb<BLK, D>(acc, pf, vs, kLd, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= inv[0];
    acc[nt][1] *= inv[0];
    acc[nt][2] *= inv[1];
    acc[nt][3] *= inv[1];
  }
  store_rows<D>(out + base * D, acc, row_lo, T, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_lo + 8 * i;
      if (r < T) lse[base + r] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
    }
  }
}

template <int BLK, int D>
int launch(const void* q, const void* k, const void* v, const void* idx, const void* cnt,
           void* out, void* lse, int B, int H, int T, int nq, int K, float scale, int causal,
           cudaStream_t s) {
  const int smem = smem_bytes<BLK, D>();
  cudaError_t err = cudaFuncSetAttribute(block_sparse_fwd_kernel<BLK, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nq, H, B);
  block_sparse_fwd_kernel<BLK, D><<<grid, BLK * 2, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(idx), static_cast<const int*>(cnt), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, T, nq, K, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* idx, const void* cnt,
             void* out, void* lse, int B, int H, int T, int block, int nq, int K, float scale,
             int causal, cudaStream_t s) {
  switch (block) {
    case 16: return launch<16, D>(q, k, v, idx, cnt, out, lse, B, H, T, nq, K, scale, causal, s);
    case 32: return launch<32, D>(q, k, v, idx, cnt, out, lse, B, H, T, nq, K, scale, causal, s);
    case 64: return launch<64, D>(q, k, v, idx, cnt, out, lse, B, H, T, nq, K, scale, causal, s);
    case 128: return launch<128, D>(q, k, v, idx, cnt, out, lse, B, H, T, nq, K, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128}, block in {16, 32, 64, 128}
// and T <= nq * block. Returns cudaGetLastError() (or the error of the
// shared-memory attribute call).
DS_EXPORT int block_sparse_fwd_launch(const void* q, const void* k, const void* v,
                                      const void* idx, const void* cnt, void* out, void* lse,
                                      int B, int H, int T, int D, int block, int nq, int K,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_d<64>(q, k, v, idx, cnt, out, lse, B, H, T, block, nq, K, scale, causal, s);
  if (D == 128)
    return launch_d<128>(q, k, v, idx, cnt, out, lse, B, H, T, block, nq, K, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
