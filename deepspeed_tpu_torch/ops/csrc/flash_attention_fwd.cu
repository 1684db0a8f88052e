// FlashAttention-2 forward with log-sum-exp, for Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py::_fwd_kernel.
// Same function: softmax(scale * q k^T [causal]) v with an fp32 online
// softmax, GQA-native (query head h reads KV head h / (H / Hkv)), and the
// per-row log-sum-exp; a row that attends nothing gets out = 0, lse = -inf.
// As in the TPU kernel, the probabilities are rounded to bf16 before the
// P V product and the row sums take them unrounded.
//
// Layout (the JAX one): q (B, H, T, D), k/v (B, Hkv, Tk, D) bf16, 16-byte
// aligned; out (B, H, T, D) bf16; lse (B, H, T) fp32. D is 64 or 128.
//
// What bounds it on the H100: the 4*T*Tk*D multiply-add operations per head
// (halved by causality) against the tensor-core peak at training lengths
// (T = 1024: 0.011 ms at gpt2-large's B4 H20); at short prefills (T = 128)
// the bytes. The products run on the tensor cores with warp-level mma.sync
// (m16n8k16 bf16 -> fp32, ops/csrc/mma_tile.cuh); wgmma, TMA and a software
// pipeline are later work.
//
// Design: one block per (b, h, 64-row q tile), 4 warps of 16 query rows.
// The TPU kernel keeps the whole KV head in VMEM and walks it in a
// sequential loop; here K and V stream through shared memory in 64-row tiles
// inside the block, tiles past the causal diagonal are never loaded, and the
// T and Tk edges are masked in the kernel (the TPU padded them). Each warp
// keeps its 16 x 64 scores, the running max and sum of its rows and its
// 16 x D output in registers; the probabilities go from the score
// accumulators straight into the A operand of P V.

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // key rows per tile

using namespace ds_mma;

template <int D>
constexpr int smem_bytes() {
  return (kBq + 2 * kBk) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int H, int Hkv, int T, int Tk, float scale, int causal) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBq x kLd
  bf16* ks = qs + kBq * kLd;                      // kBk x kLd
  bf16* vs = ks + kBk * kLd;                      // kBk x kLd

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBq;
  const int kvh = h / (H / Hkv);
  const size_t qoff = (size_t)(b * H + h) * T;
  const bf16* kb = k + (size_t)(b * Hkv + kvh) * Tk * D;
  const bf16* vb = v + (size_t)(b * Hkv + kvh) * Tk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const int tig2 = (lane & 3) * 2;

  load_rows<D, kBq>(qs, q + qoff * D, q0, T);

  // m: running max of each row (uniform over the row's 4 lanes); l: this
  // lane's share of the row's running sum, reduced over the 4 lanes at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  int n_tiles = (Tk + kBk - 1) / kBk;
  if (causal) n_tiles = min(n_tiles, (q0 + kBq + kBk - 1) / kBk);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBk;
    __syncthreads();  // q staged, or the previous tile's readers done
    load_rows<D, kBk>(ks, kb, k0, Tk);
    load_rows<D, kBk>(vs, vb, k0, Tk);
    __syncthreads();

    float s[kBk / 8][4];
    zero(s);
    mma_abt<D, kBk>(s, qs + warp * 16 * kLd, kLd, ks, kLd, lane);
    unsigned live = 0;  // bit nt*4 + e: score (nt, e) is attended
    float mx[2] = {DS_MASK_VALUE, DS_MASK_VALUE};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + (e >> 1) * 8, col = k0 + nt * 8 + tig2 + (e & 1);
        const bool ok = col < Tk && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] * scale : DS_MASK_VALUE;
        live |= ok ? 1u << (nt * 4 + e) : 0u;
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
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (nt * 4 + e) & 1u) ? expf(s[nt][e] - m[e >> 1]) : 0.f;
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
    uint32_t pf[kBk / 16][4];
    to_a_frags<kBk>(pf, s);
    mma_rb<kBk, D>(acc, pf, vs, kLd, lane);
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
  store_rows<D>(out + qoff * D, acc, row_lo, T, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_lo + 8 * i;
      if (r < T) lse[qoff + r] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Hkv, int T, int Tk, float scale, int causal, cudaStream_t s) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBq - 1) / kBq, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv, T, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment, D in {64, 128} and H % Hkv == 0. Returns cudaGetLastError()
// (or the error of the shared-memory attribute call).
DS_EXPORT int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int H, int Hkv, int T, int Tk, int D,
                               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128) return launch<128>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
