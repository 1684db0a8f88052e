// Block-sparse flash attention backward (dq; dk/dv), for Hopper.
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/
// block_sparse_attention.py::_bwd_dq_kernel (its pallas_call at :252) and
// ::_bwd_dkv_kernel (:270). Same function: from q, k, v, the output
// gradient dO, the forward's per-row log-sum-exp and delta = rowsum(dO * O)
// (fp32, computed by the caller), recompute s = scale * q k^T on the
// layout's active tiles (causal kv_pos <= q_pos, key positions >= T masked,
// and for dk/dv query positions >= T masked) and p = exp(s - lse) (a row
// whose lse is -inf attended nothing: it reads lse 0 and its p stays 0
// under the mask), then
//   dp = dO v^T,   ds = bf16(p * (dp - delta) * scale),
//   dq = ds k,     dk = ds^T q,   dv = bf16(p)^T dO,
// bf16 operands with fp32 accumulators and the two bf16 rounding points of
// the TPU kernels (ds before its products, p before dv's).
//
// Layout (the JAX one): q, k, v, dO, dq, dk, dv (B, H, T, D) bf16,
// contiguous, 16-byte aligned; lse, delta (B, H, T) fp32; dq walks q_idx
// (H, nq, K) / q_cnt (H, nq), dk/dv the transposed kv_idx (H, nk, Kt)
// through its plan, int32. D is 64 or 128; block is 16, 32, 64 or 128.
//
// What bounds them on the H100: the bytes, as for the forward
// (block_sparse_attention_fwd.cu). A visited tile costs 6 * block^2 * D
// operations for dq and 8 * block^2 * D for dk/dv against a gather of two
// block x D bf16 tiles (K and V for dq; Q and dO, with their lse and delta,
// for dk/dv): at gpt2-large's widths 19,680 (BigBird) and 25,600 (Fixed
// unidirectional) gathers of 16 KB, at llama3-8b's 64,896 of 8 KB, mostly
// from L2, against reading q, k, v, dO, lse and delta once and writing the
// gradients once. The transposed table is the more uneven: Fixed
// unidirectional's global columns are read by up to 61 q blocks against a
// median of 3, BigBird's by every q block.
//
// dk/dv (the design of the forward kernel, with the forward's plan over the
// transposed table): a work item is a piece of a kv block's walk over the
// q blocks that read it, cut at fixed table positions (WorkPlan, CHUNK) and
// numbered longest first; a split column's pieces write fp32 dk and dv
// partials to a workspace sized by the split columns alone, and the last to
// arrive (an integer count) sums them in piece order and writes dk and dv.
// No atomics on floats: two calls agree bit for bit. A group's first warp
// loads the item's K and V tiles once, then streams the visited q blocks'
// Q and dO tiles with TMA (3D maps over (D, T, B*H), rows past T as zeros)
// and their lse and delta with cp.async (0 past T; the copies land on the
// slot's mbarrier) into a 3-slot ring, a q block of 128 rows as two 64-row
// entries. Blocks 64 and 128 run wgmma, one warpgroup per 64 kv rows, the
// flash dk/dv kernel's products (flash_attention_bwd.cu, hopper.cuh):
// S^T = K Q^T and dP^T = V dO^T from shared memory, then dV += bf16(P^T) dO
// and dK += dS^T Q with P^T and dS^T as register A operands and dO and Q
// read MN-major. At block 64, D 64 a thread keeps 168 registers, so three
// CTAs fit on an SM (two at 188; measured, PERF.md); elsewhere up to 255
// (no producer warpgroup to feed). Blocks 16 and 32 run mma.sync in groups
// of one or two warps, four or two items a CTA, ldmatrix reading the
// swizzled tiles (a 64-row wgmma tile would mix kv blocks whose walks
// differ). Only the diagonal and T-edge entries are masked; a q block
// wholly past T or wholly before the kv block under causal is never
// loaded; a kv block no query reads gets dk = dv = 0.

// dq (PR 6's design, kept): block/16 warps a CTA, each warp 16 rows of the
// CTA's q block; one CTA per (b, h, q block) walks the q block's kv blocks
// in table order, staging K and V of each in padded shared memory, and each
// warp forms its scores, dp and ds in registers (in column sub-tiles of at
// most 64 keys) and feeds ds straight back as the A operand of dq += ds K,
// with mma.sync (ops/csrc/mma_tile.cuh). Every output element is written by
// one CTA and every sum runs in table order.

#include <math.h>

#include "block_sparse.cuh"

namespace {

using namespace ds_mma;
using namespace ds_sparse;

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

// ------------------------------------------------------------------ dk/dv

template <int BLK, int D>
struct DkvCfg {
  using G = Group<BLK>;
  static constexpr int kQr = BLK < 64 ? BLK : 64;  // q rows a ring entry: a q block, or half of one of 128
  static constexpr int kSub = BLK / kQr;           // ring entries a q block
  static constexpr int kKV = BLK * D * 2;          // the item's K or V tile
  static constexpr int kKVBlock = BLK * 128;       // a 64-column block of it
  static constexpr int kQT = kQr * D * 2;          // a Q or dO entry
  static constexpr int kQBlock = kQr * 128;
  static constexpr int kItemBytes = (2 * kKV + kStages * (2 * kQT + 2 * kQr * 4) + 1023) / 1024 * 1024;
  static constexpr int kBars = 1 + 2 * kStages;    // K/V full; a slot's full and empty
  static constexpr int kSmem = G::kItems * (kItemBytes + kBars * 8 + 4) + 1024;  // + 1024-byte alignment
  static constexpr int kPart = BLK * 2 * D;        // a piece's partials: dk rows, then dv rows
  // block 64, D 64: three CTAs an SM (at most 168 registers a thread)
  static constexpr int kMinBlocks = BLK == 64 && D == 64 ? 3 : 1;
};

template <int BLK, int D>
__global__ void __launch_bounds__(Group<BLK>::kThreads, (DkvCfg<BLK, D>::kMinBlocks))
block_sparse_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ idx, const int4* __restrict__ items,
                        const int2* __restrict__ splits, int* __restrict__ counts, float* __restrict__ ws,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int T, int nk, int Kt,
                        int n_items, int chunk, float scale, float scale_log2, int causal) {
  using C = DkvCfg<BLK, D>;
  using G = Group<BLK>;
  constexpr int kCB = D / kBox;
  constexpr int kQr = C::kQr;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = warp / G::kWarps, wig = warp % G::kWarps;  // the item group, the warp in it
  uint8_t* ks = base + gi * C::kItemBytes;
  uint8_t* vs = ks + C::kKV;
  uint8_t* qs = vs + C::kKV;  // slot s at qs + s * kQT
  uint8_t* dos = qs + kStages * C::kQT;
  float* lses = reinterpret_cast<float*>(dos + kStages * C::kQT);  // slot s at lses + s * kQr
  float* dls = lses + kStages * kQr;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::kItems * C::kItemBytes);
  uint64_t* full_kv = bars + gi * C::kBars;
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;
  int* last_flag = reinterpret_cast<int*>(bars + G::kItems * C::kBars) + gi;

  if (tid == 0) {
    for (int g = 0; g < G::kItems; ++g) {
      uint64_t* b = bars + g * C::kBars;
      mbar_init(b, 1);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(b + 1 + s, 1 + 32);  // the TMA's expect_tx and the first warp's lse/delta copies
        mbar_init(b + 1 + kStages + s, G::kWarps);
      }
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int b = blockIdx.x % B;
  const int it = (blockIdx.x / B) * G::kItems + gi;
  if (it >= n_items) return;
  const int4 item = items[it];
  const int h = item.x / nk, k0 = (item.x % nk) * BLK;
  if (k0 >= T) return;  // a kv block wholly past the sequence: nothing to write (every piece alike)
  const int bh = b * H + h;
  const int* col_idx = idx + (size_t)item.x * Kt;
  const int end = item.y + item.z;
  // the first visited position from p: a q block wholly past T, or wholly
  // before the kv block under causal, masks every entry and is skipped
  auto next = [&](int p) {
    for (; p < end; ++p) {
      const int q0 = col_idx[p] * BLK;
      if (q0 < T && !(causal && k0 > q0)) break;
    }
    return p;
  };

  // the producer: the group's first warp (lane 0 the TMA, every lane a share
  // of lse and delta), entry `sub` of position pp next, `issued` entries so far
  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  int pp = end, sub = 0, issued = 0;
  auto issue = [&] {
    const int s = issued % kStages;
    if (issued >= kStages) mbar_wait(&empty[s], (issued / kStages - 1) & 1);
    const int q0 = col_idx[pp] * BLK + sub * kQr;
    for (int r = lane; r < kQr; r += 32) {
      const bool ok = q0 + r < T;
      cp_async_f32(lses + s * kQr + r, lse_bh + (ok ? q0 + r : 0), ok);
      cp_async_f32(dls + s * kQr + r, delta_bh + (ok ? q0 + r : 0), ok);
    }
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * C::kQT);
      for (int c = 0; c < kCB; ++c) {
        tma_load_3d(qs + s * C::kQT + c * C::kQBlock, mq, c * kBox, q0, bh, &full[s]);
        tma_load_3d(dos + s * C::kQT + c * C::kQBlock, mdo, c * kBox, q0, bh, &full[s]);
      }
    }
    cp_async_arrive(&full[s]);
    ++issued;
    if (++sub == C::kSub) {
      sub = 0;
      pp = next(pp + 1);
    }
  };
  if (wig == 0) {
    if (lane == 0) {
      mbar_expect_tx(full_kv, 2 * C::kKV);
      for (int c = 0; c < kCB; ++c) {
        tma_load_3d(ks + c * C::kKVBlock, &tk, c * kBox, k0, bh, full_kv);
        tma_load_3d(vs + c * C::kKVBlock, &tv, c * kBox, k0, bh, full_kv);
      }
    }
    pp = next(item.y);
    while (pp < end && issued < kStages) issue();
  }

  const int col2 = 2 * (lane & 3);
  const int r_lo = wig * 16 + (lane >> 2);  // this lane's kv rows of the block: r_lo, r_lo + 8
  const int kv_lo = k0 + r_lo;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(full_kv, 0);
  int n = 0;
  for (int p = next(item.y); p < end; p = next(p + 1)) {
    for (int e0 = 0; e0 < C::kSub; ++e0, ++n) {
      const int s = n % kStages;
      const int q0 = col_idx[p] * BLK + e0 * kQr;
      const uint8_t* qst = qs + s * C::kQT;
      const uint8_t* dost = dos + s * C::kQT;
      const float* ls = lses + s * kQr;
      const float* dl = dls + s * kQr;
      float st[kQr / 2], dpt[kQr / 2];  // S^T, dP^T: the warp's 16 kv rows x kQr q columns
      mbar_wait(&full[s], (n / kStages) & 1);
      __syncwarp();  // the warp converged for the .aligned products
      if constexpr (G::kWgmma) {
        const int wg = wig >> 2;
        wgmma_fence();
        mma_nt<D>(st, ks + wg * 64 * 128, C::kKVBlock, qst, C::kQBlock);
        mma_nt<D>(dpt, vs + wg * 64 * 128, C::kKVBlock, dost, C::kQBlock);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
      } else {
#pragma unroll
        for (int i = 0; i < kQr / 2; ++i) st[i] = dpt[i] = 0.f;
        uint32_t af[D / 16][4];
        ld_a_frags<D, BLK>(af, ks, wig * 16, lane);
        mma_ab_t<D, kQr, kQr>(st, af, qst, lane);
        ld_a_frags<D, BLK>(af, vs, wig * 16, lane);
        mma_ab_t<D, kQr, kQr>(dpt, af, dost, lane);
      }

      // p = exp2(s * scale * log2(e) - lse * log2(e)), masked only on the
      // q edge and the diagonal (a q row past T, whose zero-filled Q gives
      // p = exp2(0) = 1, must count nothing)
      const bool edge = q0 + kQr > T || (causal && q0 < k0 + BLK - 1);
#pragma unroll
      for (int i = 0; i < kQr / 8; ++i) {
        const float2 lp = *reinterpret_cast<const float2*>(ls + 8 * i + col2);
        const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * i + col2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          const float lv = (e & 1) ? lp.y : lp.x;
          float z = fmaf(st[x], scale_log2, isfinite(lv) ? -lv * kLog2e : 0.f);  // lse -inf reads as 0
          if (edge) {
            const int qpos = q0 + 8 * i + col2 + (e & 1), kv = kv_lo + (e >> 1) * 8;
            if (qpos >= T || (causal && kv > qpos)) z = -INFINITY;
          }
          const float pr = ex2(z);
          st[x] = pr;
          dpt[x] = pr * (dpt[x] - ((e & 1) ? dd.y : dd.x)) * scale;  // ds^T
        }
      }
      uint32_t pf[kQr / 16][4], dsf[kQr / 16][4];
      to_frags<kQr>(pf, st);
      to_frags<kQr>(dsf, dpt);
      if constexpr (G::kWgmma) {
        wgmma_fence();
        mma_rn<D, kQr / 16>(dv_acc, pf, dost, C::kQBlock);
        mma_rn<D, kQr / 16>(dk_acc, dsf, qst, C::kQBlock);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pf);
        fence_regs(dsf);
      } else {
        mma_ab<kQr, D, kQr>(dv_acc, pf, dost, lane);
        mma_ab<kQr, D, kQr>(dk_acc, dsf, qst, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
      if (wig == 0 && pp < end) issue();
    }
  }

  if (item.w >= 0) {  // a piece of a split column: its partials, then the sum by the last piece
    const int2 sp = splits[item.w];
    float* part = ws + ((size_t)(sp.x + item.y / chunk) * B + b) * C::kPart;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r_lo + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(part + rr * D + 8 * i + col2) = make_float2(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(part + (BLK + rr) * D + 8 * i + col2) =
            make_float2(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
    if (!last_to_arrive<BLK>(counts + item.w * B + b, sp.y, last_flag, gi, wig == 0 && lane == 0)) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int pc = 0; pc < sp.y; ++pc) {  // in piece order
      const float* pt = ws + ((size_t)(sp.x + pc) * B + b) * C::kPart;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = r_lo + 8 * r;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(pt + rr * D + 8 * i + col2));
          const float2 y = __ldcg(reinterpret_cast<const float2*>(pt + (BLK + rr) * D + 8 * i + col2));
          dk_acc[4 * i + 2 * r] += x.x;
          dk_acc[4 * i + 2 * r + 1] += x.y;
          dv_acc[4 * i + 2 * r] += y.x;
          dv_acc[4 * i + 2 * r + 1] += y.y;
        }
      }
    }
  }
  const size_t o = (size_t)bh * T * D;
  store_acc<D>(dk + o, dk_acc, kv_lo, T, col2);
  store_acc<D>(dv + o, dv_acc, kv_lo, T, col2);
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
               const void* delta, const void* idx, const void* items, const void* splits, void* counts,
               void* ws, void* dk, void* dv, int B, int H, int T, int nk, int Kt, int n_items, int chunk,
               float scale, int causal, cudaStream_t s) {
  using C = DkvCfg<BLK, D>;
  using G = Group<BLK>;
  static bool attr = false;
  if (const int rc = set_smem(block_sparse_dkv_kernel<BLK, D>, C::kSmem, attr)) return rc;
  if (B * H * T == 0 || n_items == 0) return 0;
  CUtensorMap tq, tdo, tk, tv;
  if (const int rc = bf16_map(&tq, q, D, T, B * H, C::kQr)) return rc;
  if (const int rc = bf16_map(&tdo, dout, D, T, B * H, C::kQr)) return rc;
  if (const int rc = bf16_map(&tk, k, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tv, v, D, T, B * H, BLK)) return rc;
  const int groups = (n_items + G::kItems - 1) / G::kItems;
  block_sparse_dkv_kernel<BLK, D><<<groups * B, G::kThreads, C::kSmem, s>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(idx), static_cast<const int4*>(items), static_cast<const int2*>(splits),
      static_cast<int*>(counts), static_cast<float*>(ws), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B,
      H, T, nk, Kt, n_items, chunk, scale, scale * kLog2e, causal);
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

// `counts` holds one zeroed int a (split column, batch entry) and `ws` the
// split columns' partials (may be null without one); the plan (items,
// splits; n_items items cut at `chunk` positions) fits the transposed table.
DS_EXPORT int block_sparse_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* idx, const void* items, const void* splits,
                                          void* counts, void* ws, void* dk, void* dv, int B, int H, int T,
                                          int D, int block, int nk, int Kt, int n_items, int chunk,
                                          float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    DS_BLOCKS(launch_dkv, 64, q, k, v, dout, lse, delta, idx, items, splits, counts, ws, dk, dv, B, H, T, nk,
              Kt, n_items, chunk, scale, causal, s);
  }
  if (D == 128) {
    DS_BLOCKS(launch_dkv, 128, q, k, v, dout, lse, delta, idx, items, splits, counts, ws, dk, dv, B, H, T, nk,
              Kt, n_items, chunk, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
