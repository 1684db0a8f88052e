// Block-sparse flash attention forward with log-sum-exp, for Hopper: a
// host-built plan that cuts long table walks at fixed positions, an
// asynchronous TMA ring of gathered K/V tiles an item, and the tensor cores.
//
// Replaces the TPU kernel deepspeed_tpu/ops/sparse_attention/
// block_sparse_attention.py::_fwd_kernel (its pallas_call at :216). Same
// function: for each query block qi of head h, softmax(scale * q k^T) v
// over only the kv blocks idx[h, qi, 0 .. cnt[h, qi]) of a static block
// layout, in table order, with an fp32 online softmax whose state is
// updated once per kv block; in a tile the causal mask is kv_pos <= q_pos
// and key positions >= T are masked. As in the TPU kernel, the
// probabilities are rounded to bf16 before the P V product and the row sums
// take them unrounded, and a row whose every visited entry is masked (or
// whose count is 0) gets out = 0 and lse = -inf.
//
// Layout (the JAX one): q, k, v, out (B, H, T, D) bf16, contiguous, 16-byte
// aligned (TMA's base alignment); lse (B, H, T) fp32; idx (H, nq, K) int32,
// T <= nq * block. D is 64 or 128; block is 16, 32, 64 or 128.
//
// What bounds it on the H100: the bytes. A visited (q block, kv block) tile
// costs 4 * block^2 * D operations against a gather of 2 * block * D * 2
// bytes of K and V, 2 * block operations a byte: far below the tensor
// cores' 295. At gpt2-large's widths (B2 H20 T4096 D64, block 64) BigBird
// and Fixed unidirectional visit 19,680 and 25,600 tiles of 16 KB, and
// llama3-8b's (B1 H32 D128, block 16, BigBird) 64,896 tiles of 8 KB: 320,
// 420 and 530 MB gathered, mostly from L2 (each kv block is read by the
// few q blocks whose walks hold it), against the 84 and 134 MB of q, k, v
// and out that the byte bound counts once. So the time is the gathers'
// latency and L2 bandwidth, an item's start (its first reads come from
// device memory), and the length of the longest walk: BigBird's global rows
// walk every kv block (64 at block 64, 256 at block 16) while the median
// row walks 6. The plan's split answers the longest walk, the ring the
// gathers' latency, and the tensor cores keep the products short beside
// the softmax.
//
// Design.
//   The plan (WorkPlan, ops/sparse_attention/block_sparse_attention.py):
// a row whose walk is longer than the block size's chunk C (CHUNK: 32 at
// blocks 16, 32 and 64, 16 at 128) is cut at the table positions 0, C, 2C,
// ...; the pieces are work items of their own, numbered longest first, so
// the longest item is a few times the median walk and the long pieces
// start first. The grid is (groups of items) x B, item-major: a CTA runs
// one item a group and the card deals the CTAs in order.
//   The merge: an unsplit row writes out and lse directly. A split row's
// piece writes its (m, l, unnormalized acc) rows in fp32 to a workspace
// sized by the split rows alone; the last piece to arrive (an integer
// count of arrivals) merges the pieces in piece order as the online softmax
// combines them, writes out and lse = m + log l (-inf where l = 0), and
// leaves the count at 0. No float atomics: two calls agree bit for bit.
//   The ring: a group's first lane loads the item's Q tile into slot 0,
// then the K and V tiles of the visited table positions, read from the
// table ahead, with TMA into kStages = 3 slots (full and empty mbarriers),
// refilling a slot as soon as every warp of the group has read it. Each
// warp keeps its Q rows in registers (ldmatrix), so slot 0 then takes a K/V
// tile and an item holds no Q tile in shared memory: at block 64, D 64 a
// CTA takes 49 KB and four fit on an SM (three with a Q tile; measured,
// PERF.md). The tensor maps are 3D, (D, T, B*H), boxes of (64 columns,
// block rows, one head) in the 128-byte swizzle (two a row at D = 128):
// rows past T come back as zeros, never as the next head's rows. TMA boxes
// of 16 rows work as well as larger ones, so blocks 16 and 32 use TMA too
// (no cp.async fallback).
//   The tensor cores: blocks 64 and 128 run wgmma, one warpgroup per 64 q
// rows: S = Q K^T with Q from registers and K from the swizzled tile
// (m64n64 or m64n128), P rounded to bf16 from the score registers as the A
// operand of O += P V, V read MN-major from the same tile
// (flash_attention_fwd.cu's products, hopper.cuh). Blocks 16 and 32 run
// mma.sync (wgmma needs 64 rows, and a 64-row tile would mix q blocks whose
// walks differ): a CTA takes four items of one warp at block 16 and two of
// two warps at block 32, every warp 16 q rows, ldmatrix reading the
// swizzled tiles. Every CTA has at least four warps.
//   A kv block wholly above the diagonal under causal, or wholly past T,
// changes nothing (every entry masked) and is never loaded; only the
// diagonal and the T-edge tiles are masked. Rows past T are not written.
//   Tried and dropped (PERF.md): a persistent grid whose ring runs on across
// items (the group's first lane then stalls its own warps on the next
// item's table lookups: slower), an L2 prefetch of a later CTA's first
// tiles (slower), cutting the walks at 8 or 16 positions at block 64 (each
// piece's start and the merge cost more than the balance gains).

#include <math.h>

#include "block_sparse.cuh"

namespace {

using namespace ds_sparse;

template <int BLK, int D>
struct Cfg {
  using G = Group<BLK>;
  static constexpr int kTile = BLK * D * 2;      // a Q, K or V tile
  static constexpr int kBlockBytes = BLK * 128;  // a 64-column block of a tile
  static constexpr int kItemBytes = 2 * kTile * kStages;  // a slot: K and V (or Q, first)
  static constexpr int kBars = 2 * kStages;      // a slot's full and empty
  static constexpr int kSmem = G::kItems * (kItemBytes + kBars * 8 + 4) + 1024;  // + 1024-byte alignment
  static constexpr int kPart = BLK * (D + 2);    // a piece's partials: m, l, then the acc rows
  // block 64, D 64: four CTAs an SM (49 KB of shared memory each, at most
  // 128 registers a thread)
  static constexpr int kMinBlocks = BLK == 64 && D == 64 ? 4 : 1;
};

template <int BLK, int D>
__global__ void __launch_bounds__(Group<BLK>::kThreads, (Cfg<BLK, D>::kMinBlocks))
block_sparse_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const int* __restrict__ idx,
                        const int4* __restrict__ items, const int2* __restrict__ splits, int* __restrict__ counts,
                        float* __restrict__ ws, bf16* __restrict__ out, float* __restrict__ lse, int B, int H,
                        int T, int nq, int K, int n_items, int chunk, float scale_log2, int causal) {
  using C = Cfg<BLK, D>;
  using G = Group<BLK>;
  constexpr int kCB = D / kBox;  // 64-column blocks of a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = warp / G::kWarps, wig = warp % G::kWarps;  // the item group, the warp in it
  uint8_t* ks = base + gi * C::kItemBytes;  // slot s at ks + s * kTile; Q first, in slot 0
  uint8_t* vs = ks + kStages * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + G::kItems * C::kItemBytes);
  uint64_t* full = bars + gi * C::kBars;
  uint64_t* empty = full + kStages;
  int* last_flag = reinterpret_cast<int*>(bars + G::kItems * C::kBars) + gi;

  if (tid == 0) {
    for (int g = 0; g < G::kItems; ++g) {
      uint64_t* b = bars + g * C::kBars;
      for (int s = 0; s < kStages; ++s) {
        mbar_init(b + s, 1);
        mbar_init(b + kStages + s, G::kWarps);
      }
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

  // the producer: the group's first lane, position pp next, `issued` ring
  // entries so far (entry 0 is the Q tile, then a K and V tile a position)
  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  const bool leader = wig == 0 && lane == 0;
  int pp = end, issued = 0;
  auto issue = [&] {
    const int s = issued % kStages;
    if (issued >= kStages) mbar_wait(&empty[s], (issued / kStages - 1) & 1);
    mbar_expect_tx(&full[s], 2 * C::kTile);
    const int k0 = row_idx[pp] * BLK;
    for (int c = 0; c < kCB; ++c) {
      tma_load_3d(ks + s * C::kTile + c * C::kBlockBytes, mk, c * kBox, k0, bh, &full[s]);
      tma_load_3d(vs + s * C::kTile + c * C::kBlockBytes, mv, c * kBox, k0, bh, &full[s]);
    }
    ++issued;
    pp = next(pp + 1);
  };
  if (leader) {
    mbar_expect_tx(&full[0], C::kTile);
    for (int c = 0; c < kCB; ++c) tma_load_3d(ks + c * C::kBlockBytes, &tq, c * kBox, q0, bh, &full[0]);
    issued = 1;
    pp = next(item.y);
    while (pp < end && issued < kStages) issue();
  }

  const int col2 = 2 * (lane & 3);
  const int r_lo = wig * 16 + (lane >> 2);  // this lane's rows of the block: r_lo, r_lo + 8
  const int row_lo = q0 + r_lo;
  // accumulator 4i..4i+3 is n8 tile i: (r_lo, 8i + col2 + {0, 1}), (r_lo + 8, ...)
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m: running max of each row in log2 units (uniform over the row's quad);
  // l: this lane's share of the row's running sum, summed over the quad at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the warp's Q rows as A fragments, kept in registers for the walk; the
  // slot then takes a K/V tile
  uint32_t qf[D / 16][4];
  mbar_wait(&full[0], 0);
  ld_a_frags<D, BLK>(qf, ks, wig * 16, lane);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[0]);
  if (leader && pp < end) issue();

  int n = 1;  // ring entries consumed
  for (int p = next(item.y); p < end; p = next(p + 1), ++n) {
    const int s = n % kStages;
    const int k0 = row_idx[p] * BLK;
    const uint8_t* kst = ks + s * C::kTile;
    const uint8_t* vst = vs + s * C::kTile;
    float sc[BLK / 2];
    mbar_wait(&full[s], (n / kStages) & 1);
    __syncwarp();  // the warp converged for the .aligned products
    if constexpr (G::kWgmma) {
      wgmma_fence();
      mma_rt<D, BLK>(sc, qf, kst, C::kBlockBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
    } else {
#pragma unroll
      for (int i = 0; i < BLK / 2; ++i) sc[i] = 0.f;
      mma_ab_t<D, BLK, BLK>(sc, qf, kst, lane);
    }

    // scores in log2 units, -inf where masked: only the T-edge tile and the
    // diagonal tile (visited kv blocks start at or below q0)
    const bool edge = k0 + BLK > T || (causal && k0 == q0);
#pragma unroll
    for (int i = 0; i < BLK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * scale_log2;
        if (edge) {
          const int row = row_lo + (e >> 1) * 8, col = k0 + 8 * i + col2 + (e & 1);
          if (col >= T || (causal && col > row)) x = -INFINITY;
        }
        sc[4 * i + e] = x;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BLK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet: every p and alpha is 0 either way
      alpha[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BLK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(sc[i] - mu[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pf[BLK / 16][4];  // P as A fragments (the bf16 rounding point)
    to_frags<BLK>(pf, sc);
    if constexpr (G::kWgmma) {
      wgmma_fence();
      mma_rn<D, BLK / 16>(o, pf, vst, C::kBlockBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
    } else {
      mma_ab<BLK, D, BLK>(o, pf, vst, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
    if (leader && pp < end) issue();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (item.w >= 0) {  // a piece of a split row: its partials, then the merge by the last piece
    const int2 sp = splits[item.w];
    float* part = ws + ((size_t)(sp.x + item.y / chunk) * B + b) * C::kPart;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r_lo + 8 * r;
      if ((lane & 3) == 0) {
        part[rr] = m[r];
        part[BLK + rr] = l[r];
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(part + 2 * BLK + rr * D + 8 * i + col2) =
            make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
    }
    if (!last_to_arrive<BLK>(counts + item.w * B + b, sp.y, last_flag, gi, leader)) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int pc = 0; pc < sp.y; ++pc) {  // in piece order: the online softmax's combination
      const float* pt = ws + ((size_t)(sp.x + pc) * B + b) * C::kPart;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = r_lo + 8 * r;
        const float mp = __ldcg(pt + rr), lp = __ldcg(pt + BLK + rr);
        if (lp == 0.f) continue;  // the piece saw nothing of this row
        const float mn = fmaxf(m[r], mp), a = ex2(m[r] - mn), bb = ex2(mp - mn);
        l[r] = l[r] * a + lp * bb;
        m[r] = mn;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(pt + 2 * BLK + rr * D + 8 * i + col2));
          o[4 * i + 2 * r] = o[4 * i + 2 * r] * a + x.x * bb;
          o[4 * i + 2 * r + 1] = o[4 * i + 2 * r + 1] * a + x.y * bb;
        }
      }
    }
  }

  bf16* ob = out + (size_t)bh * T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row < T) {
      const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * i + col2) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if ((lane & 3) == 0) lse[(size_t)bh * T + row] = l[r] == 0.f ? -INFINITY : m[r] * kLn2 + logf(l[r]);
    }
  }
}

template <int BLK, int D>
int launch(const void* q, const void* k, const void* v, const void* idx, const void* items, const void* splits,
           void* counts, void* ws, void* out, void* lse, int B, int H, int T, int nq, int K, int n_items,
           int chunk, float scale, int causal, cudaStream_t s) {
  using C = Cfg<BLK, D>;
  using G = Group<BLK>;
  static bool attr = false;
  if (const int rc = set_smem(block_sparse_fwd_kernel<BLK, D>, C::kSmem, attr)) return rc;
  if (B * H * T == 0 || n_items == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (const int rc = bf16_map(&tq, q, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tk, k, D, T, B * H, BLK)) return rc;
  if (const int rc = bf16_map(&tv, v, D, T, B * H, BLK)) return rc;
  const int groups = (n_items + G::kItems - 1) / G::kItems;
  block_sparse_fwd_kernel<BLK, D><<<groups * B, G::kThreads, C::kSmem, s>>>(
      tq, tk, tv, static_cast<const int*>(idx), static_cast<const int4*>(items),
      static_cast<const int2*>(splits), static_cast<int*>(counts), static_cast<float*>(ws),
      static_cast<bf16*>(out), static_cast<float*>(lse), B, H, T, nq, K, n_items, chunk, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* idx, const void* items, const void* splits,
             void* counts, void* ws, void* out, void* lse, int B, int H, int T, int block, int nq, int K,
             int n_items, int chunk, float scale, int causal, cudaStream_t s) {
  switch (block) {
    case 16:
      return launch<16, D>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, nq, K, n_items, chunk,
                           scale, causal, s);
    case 32:
      return launch<32, D>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, nq, K, n_items, chunk,
                           scale, causal, s);
    case 64:
      return launch<64, D>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, nq, K, n_items, chunk,
                           scale, causal, s);
    case 128:
      return launch<128, D>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, nq, K, n_items, chunk,
                            scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment of the bf16 tensors, D in {64, 128}, block in {16, 32, 64, 128},
// T <= nq * block and that the plan (items, splits; n_items items cut at
// `chunk` positions) fits the table; `counts` holds one zeroed int a (split
// row, batch entry) and `ws` the split rows' partials (may be null without
// one). Returns cudaGetLastError() (or the error of the shared-memory
// attribute call or of a tensor map's encoding).
DS_EXPORT int block_sparse_fwd_launch(const void* q, const void* k, const void* v, const void* idx,
                                      const void* items, const void* splits, void* counts, void* ws, void* out,
                                      void* lse, int B, int H, int T, int D, int block, int nq, int K, int n_items,
                                      int chunk, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_d<64>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, block, nq, K, n_items, chunk,
                        scale, causal, s);
  if (D == 128)
    return launch_d<128>(q, k, v, idx, items, splits, counts, ws, out, lse, B, H, T, block, nq, K, n_items, chunk,
                         scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
