// FlashAttention-2 backward (dq; dk/dv) for Hopper: wgmma, a TMA producer
// warp and mbarrier rings.
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
// dv_h (B, H, Tk, D), all bf16, contiguous, 16-byte aligned (TMA's base
// alignment); lse, delta (B, H, T) fp32. D is 64 or 128;
// T and Tk are any length (T != Tk allowed); any finite scale.
//
// What bounds it on the H100: the 7 * T * Tk * D multiply-add operations
// per head of the two kernels (halved by causality) against the 989 TFLOP/s
// of the bf16 tensor cores; at gpt2-large's training shape (B4 H20 T1024
// D64) that is 0.038 ms, against 0.022 ms for the bytes.
//
// Design: the forward's (flash_attention_fwd.cu) with a second product.
// Consumer warpgroups own 64 rows each of the CTA's tile; a producer warp's
// lane loads with TMA through 3D tensor maps over (D, T, B*H) and (D, Tk,
// B*Hkv), boxes of 64 columns in the 128-byte swizzle (two boxes a row at
// D = 128): a box at the T or Tk edge fills zeros instead of reading the
// next head's rows, so nothing past T or Tk is read (a NaN there changes no
// bit).
//   dq: one warpgroup owns 64 q rows; Q and dO load once, lse and delta of
// its rows come straight from memory; 64-key K and V tiles stream through a
// kStages ring with full and empty mbarriers. Per tile S = Q K^T and
// dP = dO V^T run as wgmma with both operands K-major;
// P = exp2(S * scale * log2(e) - lse * log2(e)) (no row max: any finite
// scale), masked only on the diagonal and Tk-edge tiles; dS is rounded to
// bf16 in registers and is the register A operand of dQ += dS K, K's tile
// read as an MN-major B (transposed, as the forward reads V).
//   dk/dv: each warpgroup owns 64 kv rows; K and V load once and stay; Q and
// dO tiles of 64 q rows stream through the ring, their lse (in log2 units)
// and delta staged into the same slot by the producer warp's lanes (0 past
// T), a causal walk starting at the first q tile that reaches the kv tile.
// Per tile S^T = K Q^T and dP^T = V dO^T run as wgmma from shared memory;
// P^T and dS^T form in registers (masked only on the diagonal and q-edge
// tiles, where rows past T, whose zero-filled Q gives p = exp2(0) = 1, must
// count nothing); dV += bf16(P^T) dO and dK += dS^T Q take them as register
// A operands, dO and Q as MN-major B.
//   Both grids are persistent (as many CTAs as fit on the card), walking
// work items numbered heaviest first (dq: the last q tile; dk/dv: the first
// kv tile, every head of a tile together) and dealt in a snake, so the
// long causal walks start first; the producer loads the next item's tiles
// while the consumers finish the last one. Every output element is written
// by one CTA and every sum runs in a fixed order: no atomics, two calls give
// bitwise-equal outputs.
//   Tilings (measured; PERF.md): dq one warpgroup a CTA, three CTAs an SM
// at D = 64 (128 registers), two at D = 128 (158); 128-key tiles at D = 64
// made ptxas serialize the wgmmas for want of registers. dk/dv at D = 64 one
// warpgroup a CTA, two CTAs an SM (168 registers); at D = 128 dK and dV
// alone are 128 fp32 a thread, so one warpgroup took 232 registers and
// owned the SM alone: two consumer warpgroups with a producer warpgroup
// that hands them its registers (setmaxnreg, 240 a consumer thread) share
// each Q/dO tile and are 10% faster. A 3-slot ring, 32-row Q/dO tiles, two
// warpgroups without setmaxnreg (spills at ptxas's 168) and deferring each
// tile's last wgmma wait past the next tile's first products (ptxas then
// serializes them) were slower.
//
// Later work: the GQA group sum inside the dk/dv kernel, one kernel for dq
// and dk/dv with an ordered dq reduction, delta fused, softmax overlapping
// the next tile's products.

#include <math.h>

#include "hopper.cuh"

namespace {

using ds_mma::bf16;
using namespace ds_hopper;

constexpr int kBox = 64;            // bf16 columns a TMA box: one 128-byte swizzled row
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lse in log2 units; -inf (the row attended nothing) reads as 0
__device__ __forceinline__ float lse_log2(float l) { return isfinite(l) ? l * kLog2e : 0.f; }

// work item n of this CTA: items are numbered heaviest first and dealt to
// the CTAs in a snake (forward on even rounds, backward on odd), so the
// CTAs' sums of walks stay level
__device__ __forceinline__ int item_of(int n) {
  const int c = blockIdx.x, G = gridDim.x;
  return n * G + ((n & 1) ? G - 1 - c : c);
}

// the KV head (b * Hkv + kv) read by query head bh = b * H + h
__device__ __forceinline__ int kv_head(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

// ------------------------------------------------------------------ dq

template <int D>
struct DqCfg {
  static constexpr int kBq = 64;                  // q rows a CTA: one consumer warpgroup
  static constexpr int kConsumerWarps = 4;
  static constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
  static constexpr int kBk = 64;                  // keys a K/V tile
  static constexpr int kQBlock = kBq * 128;       // a 64-column block of the Q or dO tile
  static constexpr int kKVBlock = kBk * 128;      // of a K or V tile
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kKVBytes = kBk * D * 2;
  static constexpr int kBars = 2 + 2 * kStages;   // Q/dO full and empty; K/V full and empty a slot
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kKVBytes + kBars * 8 + 1024;  // + alignment
  static constexpr int kMinBlocks = D == 64 ? 3 : 2;
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, DqCfg<D>::kMinBlocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int T, int Tk, int BH, int n_q,
                    float scale, float scale_log2, int causal) {
  using C = DqCfg<D>;
  constexpr int kCB = D / kBox;  // 64-column blocks of a row
  constexpr int kBk = C::kBk;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  uint8_t* dos = qs + C::kQBytes;
  uint8_t* ks = dos + C::kQBytes;  // slot s at ks + s * kKVBytes
  uint8_t* vs = ks + kStages * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + kStages * C::kKVBytes);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_kv = empty_q + 1;
  uint64_t* empty_kv = full_kv + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = n_q * BH;
  auto tiles_of = [&](int q0) {  // K/V tiles of a q tile; causal: none past the diagonal
    const int n = (Tk + kBk - 1) / kBk;
    return causal ? min(n, (q0 + C::kBq - 1) / kBk + 1) : n;
  };

  if (tid == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, C::kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_kv[s], 1);
      mbar_init(&empty_kv[s], C::kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == C::kConsumerWarps) {  // the producer: Q and dO, then K/V through the ring, item after item
    if (lane == 0) {
      int it = 0, nl = 0;  // K/V tiles streamed; items loaded
      for (int n = 0;; ++n) {
        const int item = item_of(n);
        if (item >= n_items) break;
        const int q0 = (n_q - 1 - item / BH) * C::kBq, bh = item % BH;
        const int n_tiles = tiles_of(q0);
        if (n_tiles == 0) continue;  // Tk = 0: the consumers write zeros
        const int kvbh = kv_head(bh, H, Hkv);
        if (nl > 0) mbar_wait(empty_q, (nl - 1) & 1);
        ++nl;
        mbar_expect_tx(full_q, 2 * C::kQBytes);
        for (int c = 0; c < kCB; ++c) {
          tma_load_3d(qs + c * C::kQBlock, &tq, c * kBox, q0, bh, full_q);
          tma_load_3d(dos + c * C::kQBlock, &tdo, c * kBox, q0, bh, full_q);
        }
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty_kv[s], (it / kStages - 1) & 1);
          mbar_expect_tx(&full_kv[s], 2 * C::kKVBytes);
          for (int c = 0; c < kCB; ++c) {
            tma_load_3d(ks + s * C::kKVBytes + c * C::kKVBlock, &tk, c * kBox, j * kBk, kvbh, &full_kv[s]);
            tma_load_3d(vs + s * C::kKVBytes + c * C::kKVBlock, &tv, c * kBox, j * kBk, kvbh, &full_kv[s]);
          }
        }
      }
    }
    return;
  }

  const int col2 = 2 * (lane & 3);
  int it = 0, nl = 0;
  for (int n = 0;; ++n) {
    const int item = item_of(n);
    if (item >= n_items) break;
    const int q0 = (n_q - 1 - item / BH) * C::kBq, bh = item % BH;
    const int row_lo = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row_lo, row_lo + 8
    const int n_tiles = tiles_of(q0);
    float l2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_lo + 8 * h;
      l2[h] = r < T ? lse_log2(lse[(size_t)bh * T + r]) : 0.f;
      dl[h] = r < T ? delta[(size_t)bh * T + r] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (n_tiles > 0) mbar_wait(full_q, nl++ & 1);
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      const uint8_t* kst = ks + s * C::kKVBytes;
      const uint8_t* vst = vs + s * C::kKVBytes;
      float sc[kBk / 2], dp[kBk / 2];
      mbar_wait(&full_kv[s], ph);
      wgmma_fence();
      mma_nt<D>(sc, qs, C::kQBlock, kst, C::kKVBlock);
      mma_nt<D>(dp, dos, C::kQBlock, vst, C::kKVBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0 && j == n_tiles - 1) mbar_arrive(empty_q);  // Q/dO's last reader

      // z = s * scale * log2(e) - lse * log2(e), -inf where masked
      const int k0 = j * kBk;
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) sc[i] = fmaf(sc[i], scale_log2, -l2[(i >> 1) & 1]);
      if (k0 + kBk > Tk || (causal && k0 + kBk - 1 > q0)) {  // the edge or the diagonal
#pragma unroll
        for (int i = 0; i < kBk / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_lo + (e >> 1) * 8, col = k0 + 8 * i + col2 + (e & 1);
            if (col >= Tk || (causal && col > row)) sc[4 * i + e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = ex2(sc[i]) * (dp[i] - dl[h]) * scale;  // ds
      }
      uint32_t dsf[kBk / 16][4];
      to_frags<kBk>(dsf, sc);

      wgmma_fence();
      mma_rn<D, kBk / 16>(acc, dsf, kst, C::kKVBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_kv[s]);
    }
    store_acc<D>(dq + (size_t)bh * T * D, acc, row_lo, T, col2);
  }
}

// ------------------------------------------------------------------ dk/dv

template <int D>
struct DkvCfg {
  static constexpr int WG = D == 128 ? 2 : 1;  // consumer warpgroups, 64 kv rows each
  static constexpr int kBkv = 64 * WG;         // kv rows a CTA
  static constexpr int kConsumerWarps = 4 * WG;
  // D = 128: the producer is a whole warpgroup that gives its registers to
  // the consumers (setmaxnreg): the 12 warps start at 168 registers a lane
  // (ptxas's cap for one CTA of 384 threads); the producer's 4 warps drop to
  // 24, and 4 x (168 - 24) = 8 x (240 - 168) lets the 8 consumer warps rise
  // to 240, enough for dK, dV, S^T and dP^T without a spill
  static constexpr int kProducerWarps = WG == 2 ? 4 : 1;
  static constexpr int kThreads = (kConsumerWarps + kProducerWarps) * 32;
  static constexpr int kEntryRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kBq = 64;              // q rows a streamed tile
  static constexpr int kKVBlock = kBkv * 128;  // a 64-column block of the K or V tile
  static constexpr int kQBlock = kBq * 128;    // of a Q or dO tile
  static constexpr int kKVBytes = kBkv * D * 2;
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kVecBytes = kBq * 4;   // lse or delta of a q tile
  static constexpr int kBars = 2 + 2 * kStages;  // K/V full and empty; Q/dO/lse/delta full and empty a slot
  static constexpr int kSmem =
      2 * kKVBytes + kStages * (2 * kQBytes + 2 * kVecBytes) + kBars * 8 + 1024;  // + alignment
  // D = 128: one CTA an SM (its registers and 131 KB of shared memory)
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, DkvCfg<D>::kMinBlocks)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int T, int Tk, int BH,
                     int n_kv, float scale, float scale_log2, int causal) {
  using C = DkvCfg<D>;
  constexpr int kCB = D / kBox;
  constexpr int kBq = C::kBq;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  uint8_t* vs = ks + C::kKVBytes;
  uint8_t* qs = vs + C::kKVBytes;  // slot s at qs + s * kQBytes
  uint8_t* dos = qs + kStages * C::kQBytes;
  float* lses = reinterpret_cast<float*>(dos + kStages * C::kQBytes);  // slot s at lses + s * kBq
  float* dls = lses + kStages * kBq;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(dls + kStages * kBq);
  uint64_t* empty_kv = full_kv + 1;
  uint64_t* full = empty_kv + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = n_kv * BH;
  const int n_qt = (T + kBq - 1) / kBq;
  // q tiles of a kv tile: causal, from the first that reaches it
  auto first_of = [&](int k0) { return causal ? min(k0 / kBq, n_qt) : 0; };

  if (tid == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, C::kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx and the producer warp's lse/delta stores
      mbar_init(&empty[s], C::kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= C::kConsumerWarps) {  // the producer: K and V, then Q/dO/lse/delta through the ring
    if constexpr (C::kProducerWarps == 4) setmaxnreg_dec<C::kProducerRegs>();
    if (warp > C::kConsumerWarps) return;  // one warp loads
    int it = 0, nl = 0;
    for (int n = 0;; ++n) {
      const int item = item_of(n);
      if (item >= n_items) break;
      const int k0 = (item / BH) * C::kBkv, bh = item % BH;
      const int first = first_of(k0);
      if (first == n_qt) continue;  // no query reaches the tile: the consumers write zeros
      if (lane == 0) {
        if (nl > 0) mbar_wait(empty_kv, (nl - 1) & 1);
        mbar_expect_tx(full_kv, 2 * C::kKVBytes);
        const int kvbh = kv_head(bh, H, Hkv);
        for (int c = 0; c < kCB; ++c) {
          tma_load_3d(ks + c * C::kKVBlock, &tk, c * kBox, k0, kvbh, full_kv);
          tma_load_3d(vs + c * C::kKVBlock, &tv, c * kBox, k0, kvbh, full_kv);
        }
      }
      ++nl;
      for (int j = first; j < n_qt; ++j, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQBytes);
          for (int c = 0; c < kCB; ++c) {
            tma_load_3d(qs + s * C::kQBytes + c * C::kQBlock, &tq, c * kBox, j * kBq, bh, &full[s]);
            tma_load_3d(dos + s * C::kQBytes + c * C::kQBlock, &tdo, c * kBox, j * kBq, bh, &full[s]);
          }
        }
        // the warp stages the tile's lse (in log2 units) and delta, 0 past T
        for (int r = lane; r < kBq; r += 32) {
          const int qp = j * kBq + r;
          lses[s * kBq + r] = qp < T ? lse_log2(lse[(size_t)bh * T + qp]) : 0.f;
          dls[s * kBq + r] = qp < T ? delta[(size_t)bh * T + qp] : 0.f;
        }
        mbar_arrive(&full[s]);  // every lane, after its stores
      }
    }
    return;
  }

  if constexpr (C::kProducerWarps == 4) setmaxnreg_inc<C::kConsumerRegs>();
  const int wg = warp >> 2;  // consumer warpgroup
  const int col2 = 2 * (lane & 3);
  const uint8_t* kw = ks + wg * 64 * 128;  // the warpgroup's 64 rows of each column block
  const uint8_t* vw = vs + wg * 64 * 128;
  int it = 0, nl = 0;
  for (int n = 0;; ++n) {
    const int item = item_of(n);
    if (item >= n_items) break;
    const int k0 = (item / BH) * C::kBkv, bh = item % BH;
    const int kv0 = k0 + wg * 64;  // the warpgroup's rows
    const int kv_lo = kv0 + (warp & 3) * 16 + (lane >> 2);  // this lane's kv rows: kv_lo, kv_lo + 8
    const int first = first_of(k0);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (first < n_qt) mbar_wait(full_kv, nl++ & 1);
    for (int j = first; j < n_qt; ++j, ++it) {
      const int s = it % kStages, ph = (it / kStages) & 1;
      const uint8_t* qst = qs + s * C::kQBytes;
      const uint8_t* dost = dos + s * C::kQBytes;
      const float* ls = lses + s * kBq;
      const float* ds = dls + s * kBq;
      float st[kBq / 2], dpt[kBq / 2];  // S^T, dP^T: 64 kv rows x kBq q columns
      mbar_wait(&full[s], ph);
      wgmma_fence();
      mma_nt<D>(st, kw, C::kKVBlock, qst, C::kQBlock);
      mma_nt<D>(dpt, vw, C::kKVBlock, dost, C::kQBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      __syncwarp();
      if (lane == 0 && j == n_qt - 1) mbar_arrive(empty_kv);  // K/V's last reader

      const int q0 = j * kBq;
      const bool edge = q0 + kBq > T || (causal && q0 < kv0 + 63);  // the q edge or the diagonal
#pragma unroll
      for (int i = 0; i < kBq / 8; ++i) {
        const float2 lp = *reinterpret_cast<const float2*>(ls + 8 * i + col2);
        const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * i + col2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          float z = fmaf(st[x], scale_log2, -((e & 1) ? lp.y : lp.x));
          if (edge) {
            const int qpos = q0 + 8 * i + col2 + (e & 1), kv = kv_lo + (e >> 1) * 8;
            if (qpos >= T || (causal && kv > qpos)) z = -INFINITY;
          }
          const float p = ex2(z);
          st[x] = p;
          dpt[x] = p * (dpt[x] - ((e & 1) ? dd.y : dd.x)) * scale;  // ds^T
        }
      }
      uint32_t pf[kBq / 16][4], dsf[kBq / 16][4];
      to_frags<kBq>(pf, st);
      to_frags<kBq>(dsf, dpt);

      wgmma_fence();
      mma_rn<D, kBq / 16>(dv_acc, pf, dost, C::kQBlock);
      mma_rn<D, kBq / 16>(dk_acc, dsf, qst, C::kQBlock);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pf);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    const size_t out = (size_t)bh * Tk * D;
    store_acc<D>(dk + out, dk_acc, kv_lo, Tk, col2);
    store_acc<D>(dv + out, dv_acc, kv_lo, Tk, col2);
  }
}

// ------------------------------------------------------------------ host

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Hkv, int T, int Tk, float scale,
              int causal, cudaStream_t s) {
  using C = DqCfg<D>;
  static bool attr = false;
  static int dev_cached = -1, resident = 0;
  if (const int rc = set_smem(flash_bwd_dq_kernel<D>, C::kSmem, attr)) return rc;
  if (B * H * T == 0) return 0;
  // with Tk = 0 no tile is loaded (dq is zeros): the K/V maps only need a valid base
  const void* kb = Tk ? k : q;
  const void* vb = Tk ? v : q;
  CUtensorMap tq, tdo, tk, tv;
  if (const int rc = bf16_map(&tq, q, D, T, B * H, C::kBq)) return rc;
  if (const int rc = bf16_map(&tdo, dout, D, T, B * H, C::kBq)) return rc;
  if (const int rc = bf16_map(&tk, kb, D, Tk ? Tk : 1, B * Hkv, C::kBk)) return rc;
  if (const int rc = bf16_map(&tv, vb, D, Tk ? Tk : 1, B * Hkv, C::kBk)) return rc;
  if (const int rc = resident_ctas(flash_bwd_dq_kernel<D>, C::kThreads, C::kSmem, dev_cached, resident))
    return rc;
  const int n_q = (T + C::kBq - 1) / C::kBq;
  flash_bwd_dq_kernel<D><<<min(n_q * B * H, resident), C::kThreads, C::kSmem, s>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hkv, T, Tk, B * H, n_q, scale, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Hkv, int T, int Tk,
               float scale, int causal, cudaStream_t s) {
  using C = DkvCfg<D>;
  static bool attr = false;
  static int dev_cached = -1, resident = 0;
  if (const int rc = set_smem(flash_bwd_dkv_kernel<D>, C::kSmem, attr)) return rc;
  if constexpr (C::kProducerWarps == 4) {  // the register exchange balances only from kEntryRegs
    static const int regs_rc = [] {
      cudaFuncAttributes fa;
      const int rc = static_cast<int>(cudaFuncGetAttributes(&fa, flash_bwd_dkv_kernel<D>));
      return rc ? rc : fa.numRegs == C::kEntryRegs ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
    }();
    if (regs_rc) return regs_rc;
  }
  if (B * H * Tk == 0) return 0;
  // with T = 0 no tile is loaded (dk, dv are zeros): the Q-side maps only need a valid base
  const void* qb = T ? q : k;
  const void* dob = T ? dout : k;
  CUtensorMap tq, tdo, tk, tv;
  if (const int rc = bf16_map(&tq, qb, D, T ? T : 1, B * H, C::kBq)) return rc;
  if (const int rc = bf16_map(&tdo, dob, D, T ? T : 1, B * H, C::kBq)) return rc;
  if (const int rc = bf16_map(&tk, k, D, Tk, B * Hkv, C::kBkv)) return rc;
  if (const int rc = bf16_map(&tv, v, D, Tk, B * Hkv, C::kBkv)) return rc;
  if (const int rc = resident_ctas(flash_bwd_dkv_kernel<D>, C::kThreads, C::kSmem, dev_cached, resident))
    return rc;
  const int n_kv = (Tk + C::kBkv - 1) / C::kBkv;
  flash_bwd_dkv_kernel<D><<<min(n_kv * B * H, resident), C::kThreads, C::kSmem, s>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, T, Tk, B * H, n_kv, scale, scale * kLog2e,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128}, H % Hkv == 0
// and a finite scale. Each returns cudaGetLastError() (or the error of the
// shared-memory attribute call, of the occupancy query or of a tensor map's
// encoding).
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
