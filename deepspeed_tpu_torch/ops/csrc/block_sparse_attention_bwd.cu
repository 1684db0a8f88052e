// Block-sparse flash attention backward (dq; dk/dv), for Hopper: the
// forward's host-built work plans, asynchronous TMA rings of gathered tiles
// and the tensor cores (block_sparse_attention_fwd.cu).
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
// (H, nq, K) through the forward's plan, dk/dv the transposed kv_idx
// (H, nk, Kt) through its own, int32. D is 64 or 128; block is 16, 32, 64
// or 128.
//
// What bounds them on the H100: the bytes, as for the forward. A visited
// tile costs 6 * block^2 * D operations for dq and 8 * block^2 * D for
// dk/dv against a gather of two block x D bf16 tiles (K and V for dq; Q
// and dO, with their lse and delta, for dk/dv): at gpt2-large's widths
// 19,680 (BigBird) and 25,600 (Fixed unidirectional) gathers of 16 KB, at
// llama3-8b's 64,896 of 8 KB, mostly from L2, against reading q, k, v, dO,
// lse and delta once and writing the gradients once. So, as in the
// forward, the time is the gathers' latency and L2 bandwidth, each item's
// start (its first reads come from device memory) and the longest walk.
// The tables are uneven: BigBird's global rows walk every kv block (64 at
// block 64, 256 at block 16) against a median of 6; Fixed unidirectional's
// global columns are read by up to 61 q blocks against a median of 3.
//
// Both kernels take the forward's design. A work item is a piece of a
// row's (dq: a q block's) or a column's (dk/dv: a kv block's) walk, cut at
// the fixed table positions 0, C, 2C, ... (WorkPlan, CHUNK) and numbered
// longest first; the grid is (groups of items) x B. An unsplit row or
// column writes its gradient directly; a split one's pieces write fp32
// partials to a workspace sized by the split rows alone, and the last to
// arrive (an integer count of arrivals, left at 0) sums them in piece order
// and writes the gradient. No atomics on floats: two calls agree bit for
// bit. A CTA is the forward's Group: blocks 64 and 128 one item on one or
// two warpgroups (wgmma), blocks 16 and 32 four or two items of one or two
// warps on mma.sync (a 64-row wgmma tile would mix rows whose walks
// differ), every warp 16 rows of its item's block and every CTA at least
// four warps. The tiles come by TMA through 3D maps over (D, T, B*H), boxes
// of 64 columns in the 128-byte swizzle (two a row at D = 128; rows past T
// as zeros), into a ring of slots with full and empty mbarriers; ldmatrix
// reads them at blocks 16 and 32 (sw_off). Only the diagonal and
// T-edge tiles are masked; a block wholly masked (past T, or beyond the
// diagonal under causal) is never loaded.
//
// dq (the forward's plan over the q table, attn.plans[0], unchanged: its
// cuts are the forward's). A group's first lane loads the item's Q and dO
// tiles once, then the K and V tiles of the visited table positions, read
// ahead from the table, into the ring; each warp reads its rows' lse and
// delta once. Per tile: S = Q K^T and dP = dO V^T, p and dS in registers,
// dS rounded to bf16 as the A operand of dQ += dS K with K's tile read
// MN-major. A piece's partial is block x D floats a batch entry (a plain
// sum: no m or l).
//   Blocks 64 and 128 (wgmma; a 128-key tile as two 64-key halves): Q and
// dO stay in shared memory past a ring of two K/V slots, S and dP take
// both operands K-major from shared memory (mma_nt) and dQ += dS K takes
// dS from registers (mma_rn): flash_attention_bwd.cu's dq products. At
// block 64, D 64 a thread then needs 128 registers (S, dP and dQ 96, dS
// 16) and a CTA 49 KB, so four CTAs fit an SM. Measured (PERF.md): Q and
// dO as register fragments with three slots (164 registers, three CTAs)
// and Q and dO in shared memory with three slots (140 registers, three
// CTAs of 65 KB) were 3-5% and 8-10% slower; as in the forward, CTAs an
// SM set the time more than the ring's depth.
//   Blocks 16 and 32 (mma.sync): Q and dO come first in slot 0 of a
// three-slot ring, each warp takes its rows of both into registers as A
// fragments (ldmatrix) and frees the slot; S and dP by mma_ab_t, dQ by
// mma_ab. At block 16, D 128 a thread keeps 208 registers and a CTA of
// four items 97 KB: two CTAs an SM (two slots measured the same).

// dk/dv (the forward's design over the transposed table, attn.plans[1]):
// a group's first warp loads the item's K and V tiles once, then streams
// the visited q blocks' Q and dO tiles with TMA and their lse and delta
// with cp.async (0 past T; the copies land on the slot's mbarrier), a q
// block of 128 rows as two 64-row entries. Blocks 64 and 128 run the flash
// dk/dv kernel's products (flash_attention_bwd.cu, hopper.cuh): S^T =
// K Q^T and dP^T = V dO^T from shared memory, then dV += bf16(P^T) dO and
// dK += dS^T Q with P^T and dS^T as register A operands and dO and Q read
// MN-major. At block 64, D 64 a thread keeps 168 registers, so three CTAs
// fit on an SM (two at 188; measured, PERF.md); elsewhere up to 255 (no
// producer warpgroup to feed). A kv block no query reads gets dk = dv = 0.
//
// Tried and dropped for dq: the first port's design, one CTA of block / 16
// warps per q block walking the whole row in table order with K and V
// staged by synchronous loads between two barriers (one warp a CTA at
// block 16, the 256-block global rows on one warp, nothing overlapping a
// load: 10-42x its bound; PERF.md).

#include <math.h>

#include "block_sparse.cuh"

namespace {

using namespace ds_mma;
using namespace ds_sparse;

// ------------------------------------------------------------------ dq

template <int BLK, int D>
struct DqCfg {
  using G = Group<BLK>;
  static constexpr int kKt = G::kWgmma ? 64 : BLK;  // keys a product: a tile, or half of one of 128
  static constexpr int kTile = BLK * D * 2;         // a Q, dO, K or V tile
  static constexpr int kBlockBytes = BLK * 128;     // a 64-column block of a tile
  // wgmma: two K/V slots, then Q and dO for the walk; mma.sync: three
  // slots, Q and dO first in slot 0 (entry 0 of the ring)
  static constexpr int kSlots = G::kWgmma ? 2 : kStages;
  static constexpr int kFirst = G::kWgmma ? 0 : 1;  // ring entries before the first K/V tile
  static constexpr int kItemBytes = 2 * kTile * (kSlots + (G::kWgmma ? 1 : 0));
  static constexpr int kBars = 2 * kSlots + 1;      // a slot's full and empty; wgmma: Q/dO's full
  static constexpr int kSmem = G::kItems * (kItemBytes + kBars * 8 + 4) + 1024;  // + 1024-byte alignment
  static constexpr int kPart = BLK * D;             // a piece's partial dq rows
  // block 64, D 64: four CTAs an SM (49 KB of shared memory each, at most
  // 128 registers a thread)
  static constexpr int kMinBlocks = BLK == 64 && D == 64 ? 4 : 1;
};

template <int BLK, int D>
__global__ void __launch_bounds__(Group<BLK>::kThreads, (DqCfg<BLK, D>::kMinBlocks))
block_sparse_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ idx, const int4* __restrict__ items,
                       const int2* __restrict__ splits, int* __restrict__ counts, float* __restrict__ ws,
                       bf16* __restrict__ dq, int B, int H, int T, int nq, int K, int n_items, int chunk,
                       float scale, float scale_log2, int causal) {
  using C = DqCfg<BLK, D>;
  using G = Group<BLK>;
  constexpr int kCB = D / kBox;  // 64-column blocks of a row
  constexpr int kKt = C::kKt;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = warp / G::kWarps, wig = warp % G::kWarps;  // the item group, the warp in it
  constexpr int kSlots = C::kSlots;
  uint8_t* ks = base + gi * C::kItemBytes;  // slot s at ks + s * kTile
  uint8_t* vs = ks + kSlots * C::kTile;
  uint8_t* qs = G::kWgmma ? vs + kSlots * C::kTile : ks;  // Q and dO: past the ring, or in slot 0
  uint8_t* dos = G::kWgmma ? qs + C::kTile : vs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::kItems * C::kItemBytes);
  uint64_t* full = bars + gi * C::kBars;
  uint64_t* empty = full + kSlots;
  uint64_t* full_q = G::kWgmma ? empty + kSlots : full;  // Q and dO landed
  int* last_flag = reinterpret_cast<int*>(bars + G::kItems * C::kBars) + gi;

  if (tid == 0) {
    for (int g = 0; g < G::kItems; ++g) {
      uint64_t* b = bars + g * C::kBars;
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(b + s, 1);
        mbar_init(b + kSlots + s, G::kWarps);
      }
      mbar_init(b + 2 * kSlots, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int b = blockIdx.x % B;
  const int it = (blockIdx.x / B) * G::kItems + gi;
  if (it >= n_items) return;
  const int4 item = items[it];
  const int h = item.x / nq, q0 = (item.x % nq) * BLK;
  if (q0 >= T) return;  // a q block wholly past the sequence: nothing to write (every piece alike)
  const int bh = b * H + h;
  const int* row_idx = idx + (size_t)item.x * K;
  const int end = item.y + item.z;
  // the first visited position from p: a kv block wholly past T, or wholly
  // above the diagonal under causal, masks every entry and is skipped
  auto next = [&](int p) {
    for (; p < end; ++p) {
      const int k0 = row_idx[p] * BLK;
      if (k0 < T && !(causal && k0 > q0)) break;
    }
    return p;
  };
  const int first = next(item.y);  // an item that visits nothing loads nothing and writes zeros

  // the producer: the group's first lane, position pp next, `issued` ring
  // entries so far (a K and V tile a position; at mma.sync entry 0 is the
  // Q and dO tiles)
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  const bool leader = wig == 0 && lane == 0;
  int pp = end, issued = 0;
  auto issue = [&] {
    const int s = issued % kSlots;
    if (issued >= kSlots) mbar_wait(&empty[s], (issued / kSlots - 1) & 1);
    mbar_expect_tx(&full[s], 2 * C::kTile);
    const int k0 = row_idx[pp] * BLK;
    for (int c = 0; c < kCB; ++c) {
      tma_load_3d(ks + s * C::kTile + c * C::kBlockBytes, mk, c * kBox, k0, bh, &full[s]);
      tma_load_3d(vs + s * C::kTile + c * C::kBlockBytes, mv, c * kBox, k0, bh, &full[s]);
    }
    ++issued;
    pp = next(pp + 1);
  };
  if (leader && first < end) {
    mbar_expect_tx(full_q, 2 * C::kTile);
    for (int c = 0; c < kCB; ++c) {
      tma_load_3d(qs + c * C::kBlockBytes, &tq, c * kBox, q0, bh, full_q);
      tma_load_3d(dos + c * C::kBlockBytes, &tdo, c * kBox, q0, bh, full_q);
    }
    issued = C::kFirst;
    pp = first;
    while (pp < end && issued < kSlots) issue();
  }

  const int col2 = 2 * (lane & 3);
  const int r_lo = wig * 16 + (lane >> 2);  // this lane's rows of the block: r_lo, r_lo + 8
  const int row_lo = q0 + r_lo;
  // each row's lse in log2 units (-inf, a row that attended nothing, reads
  // as 0) and delta; rows past T read nothing (their zero-filled dO gives
  // dp = 0, so ds = 0, and they are not written)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    const float lv = row < T ? lse[(size_t)bh * T + row] : 0.f;
    l2[r] = isfinite(lv) ? lv * kLog2e : 0.f;
    dl[r] = row < T ? delta[(size_t)bh * T + row] : 0.f;
  }
  // accumulator 4i..4i+3 is n8 tile i: (r_lo, 8i + col2 + {0, 1}), (r_lo + 8, ...)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // mma.sync: the warp's Q and dO rows as A fragments, kept in registers
  // for the walk; slot 0 then takes a K/V tile. wgmma: Q and dO stay in
  // shared memory.
  uint32_t qf[D / 16][4], dof[D / 16][4];
  if (first < end) {
    mbar_wait(full_q, 0);
    if constexpr (!G::kWgmma) {
      ld_a_frags<D, BLK>(qf, qs, wig * 16, lane);
      ld_a_frags<D, BLK>(dof, dos, wig * 16, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[0]);
      if (leader && pp < end) issue();
    }
  }

  int n = C::kFirst;  // ring entries consumed
  for (int p = first; p < end; p = next(p + 1), ++n) {
    const int s = n % kSlots;
    const int k0 = row_idx[p] * BLK;
    const bool edge = k0 + BLK > T || (causal && k0 == q0);  // the T-edge or the diagonal tile
    mbar_wait(&full[s], (n / kSlots) & 1);
    __syncwarp();  // the warp converged for the .aligned products
#pragma unroll
    for (int c0 = 0; c0 < BLK; c0 += kKt) {  // 64 keys at a time at block 128
      const uint8_t* kst = ks + s * C::kTile + c0 * 128;
      const uint8_t* vst = vs + s * C::kTile + c0 * 128;
      float sc[kKt / 2], dp[kKt / 2];
      if constexpr (G::kWgmma) {
        const uint8_t* qw = qs + (wig >> 2) * 64 * 128;  // the warpgroup's 64 rows
        const uint8_t* dow = dos + (wig >> 2) * 64 * 128;
        wgmma_fence();
        mma_nt<D, kKt>(sc, qw, C::kBlockBytes, kst, C::kBlockBytes);
        mma_nt<D, kKt>(dp, dow, C::kBlockBytes, vst, C::kBlockBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
      } else {
#pragma unroll
        for (int i = 0; i < kKt / 2; ++i) sc[i] = dp[i] = 0.f;
        mma_ab_t<D, BLK, BLK>(sc, qf, kst, lane);
        mma_ab_t<D, BLK, BLK>(dp, dof, vst, lane);
      }

      // p = exp2(s * scale * log2(e) - lse * log2(e)), 0 where masked;
      // ds = p * (dp - delta) * scale
#pragma unroll
      for (int i = 0; i < kKt / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e, r = e >> 1;
          float z = fmaf(sc[x], scale_log2, -l2[r]);
          if (edge) {
            const int row = row_lo + 8 * r, col = k0 + c0 + 8 * i + col2 + (e & 1);
            if (col >= T || (causal && col > row)) z = -INFINITY;
          }
          sc[x] = ex2(z) * (dp[x] - dl[r]) * scale;
        }
      }
      uint32_t dsf[kKt / 16][4];  // dS as A fragments (the bf16 rounding point)
      to_frags<kKt>(dsf, sc);
      if constexpr (G::kWgmma) {
        wgmma_fence();
        mma_rn<D, kKt / 16>(acc, dsf, kst, C::kBlockBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(dsf);
      } else {
        mma_ab<BLK, D, BLK>(acc, dsf, kst, lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
    if (leader && pp < end) issue();
  }

  if (item.w >= 0) {  // a piece of a split row: its partial, then the sum by the last piece
    const int2 sp = splits[item.w];
    float* part = ws + ((size_t)(sp.x + item.y / chunk) * B + b) * C::kPart;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r_lo + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(part + rr * D + 8 * i + col2) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
    if (!last_to_arrive<BLK>(counts + item.w * B + b, sp.y, last_flag, gi, leader)) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int pc = 0; pc < sp.y; ++pc) {  // in piece order
      const float* pt = ws + ((size_t)(sp.x + pc) * B + b) * C::kPart;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = r_lo + 8 * r;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(pt + rr * D + 8 * i + col2));
          acc[4 * i + 2 * r] += x.x;
          acc[4 * i + 2 * r + 1] += x.y;
        }
      }
    }
  }
  store_acc<D>(dq + (size_t)bh * T * D, acc, row_lo, T, col2);
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
              const void* delta, const void* idx, const void* items, const void* splits, void* counts,
              void* ws, void* dq, int B, int H, int T, int nq, int K, int n_items, int chunk, float scale,
              int causal, cudaStream_t s) {
  using C = DqCfg<BLK, D>;
  using G = Group<BLK>;
  static bool attr = false;
  if (const int rc = set_smem(block_sparse_dq_kernel<BLK, D>, C::kSmem, attr)) return rc;
  if (B * H * T == 0 || n_items == 0) return 0;
  CUtensorMap tq, tdo, tk, tv;
  if (const int rc = bf16_map(&tq, q, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tdo, dout, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tk, k, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tv, v, D, T, B * H, BLK)) return rc;
  const int groups = (n_items + G::kItems - 1) / G::kItems;
  block_sparse_dq_kernel<BLK, D><<<groups * B, G::kThreads, C::kSmem, s>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(idx), static_cast<const int4*>(items), static_cast<const int2*>(splits),
      static_cast<int*>(counts), static_cast<float*>(ws), static_cast<bf16*>(dq), B, H, T, nq, K, n_items,
      chunk, scale, scale * kLog2e, causal);
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

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128}, block in {16, 32, 64, 128},
// T <= (number of table rows) * block and that the plan (items, splits;
// n_items items cut at `chunk` positions) fits the table. `counts` holds
// one zeroed int a (split row or column, batch entry) and `ws` the split
// rows' or columns' partials (may be null without one). Each returns
// cudaGetLastError() (or the error of the shared-memory attribute call or
// of a tensor map's encoding).
DS_EXPORT int block_sparse_bwd_dq_launch(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* idx, const void* items, const void* splits,
                                         void* counts, void* ws, void* dq, int B, int H, int T, int D,
                                         int block, int nq, int K, int n_items, int chunk, float scale,
                                         int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    DS_BLOCKS(launch_dq, 64, q, k, v, dout, lse, delta, idx, items, splits, counts, ws, dq, B, H, T, nq, K,
              n_items, chunk, scale, causal, s);
  }
  if (D == 128) {
    DS_BLOCKS(launch_dq, 128, q, k, v, dout, lse, delta, idx, items, splits, counts, ws, dq, B, H, T, nq, K,
              n_items, chunk, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the same for dk/dv over the transposed table
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
