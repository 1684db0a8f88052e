// The two mainloops of the int8-weight tensor-core product, shared by
// quant_matmul.cu and by kernels A and C of the fused decode layer
// (fused_qkv_ln.cu, fused_out_mlp.cu): out = x @ dequant(qw, scales), x
// (M, K) bf16 row-major, qw (K, N) int8, scales (G, N) fp32, gs = K / G.
//
// Both paths compute out^T = W^T x^T: N lies on the tensor core's row side
// (the A operand, the widened weight, from registers) and M on its column
// side (the B operand, x, from shared memory). A warp reads 32 K rows x 16
// columns of the stage's int8 weight tile with one ldmatrix.trans (b16
// units, so a lane gets two K rows of a column pair) and widens the bytes in
// registers into the A fragments of two k16 steps (int8_mma.cuh): column
// 2g of the warp's 16 is A row g, column 2g + 1 row g + 8, on both paths.
//   M <= 32: mma.sync m16n8k16. A block's 8 warps each own 16 of its 128
// columns and 8, 16 or 32 rows; K streams through a ring of 6 stages of 64
// rows (cp.async, zero-filled past the edges).
//   M > 32: wgmma m64n128k16 (BM = 128 rows of x a block) or m64n64k16
// (BM = 64, where 128-row tiles leave the card's SMs idle), A from
// registers. A block is two consumer warpgroups and a producer warp; a
// warpgroup's four warps hold its 64 columns' A tile, and the BM rows of x
// are the wgmma's n. The producer streams K one segment a stage (the
// weight's 128 x 128 int8 tile and x's two BM x 64 boxes) through a ring
// with TMA (128-byte swizzle, zero-filled past the tensors' edges; a full
// and an empty mbarrier per slot, one wait and one release a segment). Each
// half of a stage's four wgmmas run while the next half's int8 tile is
// widened. TMA wants 16-byte rows and the ring whole 128-row segments: a
// shape with N % 16 or gs % 128 runs the M <= 32 path at every M.
//   What bounds the wgmma path: feeding the tensor cores, not their rate:
// the bytes of a stage (48 KB at BM = 128 for 4.2 MFLOP, 32 KB at BM = 64
// for 2.1) through L2, and the widening and barriers between its halves.
// A stage is a whole segment, not half of one, for one barrier round trip
// a segment.
//
// The sum. K is cut into segments of at most 128 rows that never cross a
// quantization group (a group of 128 is one segment). A segment's product
// starts from zero and runs over its k16 steps in K order; then
// total = fma(partial, scale[group][n], total), segment after segment in K
// order, from total = 0.
//
// Batch invariance: a row's bits depend on (K, N, G) alone, never on M or
// on the launch plan. Every plan runs the same segment partials (16-term
// tensor-core products in the same K order) and the same fma chain;
// wgmma (n = 64 or 128) and mma.sync give the same bits for the same
// products, wherever a row or a column sits in its tile: held on the card
// by the invariance checks of chip_smoke.py (qmm_invariance,
// block_invariance) and tests/test_torch_kernels_cuda.py, not assumed. A
// plan chooses only the instruction, the tile and where the chain runs: in
// registers (kChain), or each segment's partial goes to a workspace
// ws[pass][segment][M][N] and qmm_reduce_kernel runs the same chain over
// the segments in order (K split over blocks to fill the card). No atomics
// and no fence: two calls give the same bits.
//
// Passes: a call may carry two weights of one shape and grouping (kernel
// C's up and gate), each a pass over the same x. The chain of each is the
// one above; the epilogue sees both finished sums of a (row, column).
//
// Epilogues. A plain one (kStaged false: quant_matmul's store) takes the
// finished pair of columns (n, n + 1) of a row from registers. A staged one
// (kStaged true: the fused layer's) sees the block's finished tile in
// shared memory (Fin: plane = pass, row, column) and is called once per
// pair of columns, so it may read a neighbour pair (RoPE's partner, hd / 2
// away, in another warp or warpgroup).
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace ds_qmm {

using ds_mma::bf16;
using ds_mma::mma16816;
using ds_mma::smem_u32;
using namespace ds_hopper;
using namespace ds_int8;

constexpr int kSegK = 128;   // K rows of a segment
constexpr int kBlockN = 128; // columns of a block, every path
constexpr int kWLd = kBlockN + 16;  // int8 stage row stride: 8 ldmatrix rows in distinct banks
constexpr int kFinLd = kBlockN + 4;  // fp32 row stride of a staged tile

// segment s of K: [k0, k1) inside group g (segments number group-major, spg
// of them a group, the last of a group shorter when 128 does not divide gs)
struct Seg {
  int k0, k1, g;
};
__device__ __forceinline__ Seg seg_of(int s, int gs, int spg) {
  const int g = spg == 1 ? s : s / spg;
  const int k0 = g * gs + (s - g * spg) * kSegK;
  return {k0, min(k0 + kSegK, (g + 1) * gs), g};
}

// One call's operands: x and one or two weights (passes) of one shape.
struct Operands {
  const bf16* x;
  const int8_t* w[2];
  const float* scales[2];
  float* ws;  // the segment partials, [pass][segment][M][N] fp32 (split plans)
  int* flags;  // one zeroed int a block tile, left zeroed (the narrow path's arrivals)
  int M, K, N, gs, spg, segs, passes;
};

// A block's finished sums in shared memory: pass p, row r, column c
struct Fin {
  const float* s;
  int plane;
  __device__ __forceinline__ float operator()(int p, int r, int c) const {
    return s[p * plane + r * kFinLd + c];
  }
};

// the epilogue of a partials pass: nothing is finished there
struct NoEpi {
  static constexpr bool kStaged = false;
  static constexpr int kPasses = 1;
  __device__ void pair(int, int, float, float) const {}
};

// every pair of columns (c, c + 1) of a staged tile's rows inside the
// output, kThreads threads, fully unrolled: the epilogue's loads are
// read-only (__ldg), so all of a thread's are in flight together
template <int kRows, int kThreads, typename Epi>
__device__ __forceinline__ void apply_tile(const Epi& epi, const Fin& f, int m0, int rows, int n0,
                                           int N, int tid) {
  constexpr int kPairs = kBlockN / 2;
  static_assert(kRows * kPairs % kThreads == 0, "whole rounds of pairs");
#pragma unroll
  for (int it = 0; it < kRows * kPairs / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kPairs, c = (i - r * kPairs) * 2;
    if (r < rows && n0 + c < N) epi(f, r, c, m0 + r, n0 + c);  // N % 4 == 0: n0 + c + 1 < N too
  }
}

// 8 bf16 of x (row m, K from k) into dst: cp.async when vec (gs % 8 == 0:
// a piece is all inside the segment or all past it), else one by one
__device__ __forceinline__ void load_x8(bf16* dst, const bf16* __restrict__ x, int m, int k, int M,
                                        int K, int k1, bool vec) {
  if (vec) {
    const bool in = m < M && k < k1;
    cp_async16(dst, in ? x + (size_t)m * K + k : x, in);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = m < M && k + j < k1 ? x[(size_t)m * K + k + j] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the 256 consumer threads of a wide block (the producer warp has left)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Programmatic dependent launch: a launch issued with pdl (the fused layer's
// chains) may start while the launch before it finishes. Every thread lets
// the next launch start (pdl_release) on entry, and waits for the previous
// launch's results to be complete and visible (pdl_wait) before it reads
// anything but weights or writes anything: memory the caching allocator
// handed on from the previous launch is then safe too. Without pdl both are
// no-ops.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_release() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// the ordered chain of one (row m, columns n and n + 1) over a pass's segment
// partials: total = fma(partial, scale, total), segment after segment
__device__ __forceinline__ float2 chain_pair(const Operands& op, int pass, int m, int n) {
  const int M = op.M, N = op.N, segs = op.segs, spg = op.spg;
  const float* __restrict__ ws = op.ws + (size_t)pass * segs * M * N;
  const float* __restrict__ scales = pass ? op.scales[1] : op.scales[0];
  float2 tot = make_float2(0.f, 0.f);
  for (int s0 = 0; s0 < segs; s0 += 8) {
    float2 p[8], sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // issue the loads of 8 segments before their sums
      const int s = min(s0 + j, segs - 1);
      p[j] = __ldcg(reinterpret_cast<const float2*>(ws + ((size_t)s * M + m) * N + n));
      sc[j] = __ldg(reinterpret_cast<const float2*>(scales + (size_t)(s / spg) * N + n));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (s0 + j < segs) {
        tot.x = __fmaf_rn(p[j].x, sc[j].x, tot.x);
        tot.y = __fmaf_rn(p[j].y, sc[j].y, tot.y);
      }
    }
  }
  return tot;
}

// ------------------------------------------------------ M <= 32: mma.sync

constexpr int kNarrowThreads = 256;  // 8 warps x 16 columns
constexpr int kNarrowStages = 6;
constexpr int kNarrowSK = 64;        // K rows of a stage: two ldmatrix.trans reads
constexpr int kXLd = kNarrowSK + 8;  // bf16 x row stride (144 bytes: conflict-free ldmatrix)

// a stage's K rows x 128 columns of the weight into its int8 tile, 16-byte
// pieces; vec: every piece lies inside qw or past its edge (N % 16 == 0),
// so cp.async copies it, else 4-byte words load one by one
__device__ __forceinline__ void load_w(uint8_t* st, const int8_t* __restrict__ qw, int kb, int k1,
                                       int n_blk, int N, bool vec, int tid) {
#pragma unroll
  for (int it = 0; it < kNarrowSK * 8 / kNarrowThreads; ++it) {
    const int i = tid + it * kNarrowThreads;
    const int r = i >> 3, q = i & 7;
    const int k = kb + r, n = n_blk + q * 16;
    int8_t* dst = reinterpret_cast<int8_t*>(st + r * kWLd + q * 16);
    if (vec) {
      const bool in = k < k1 && n < N;
      cp_async16(dst, in ? qw + (size_t)k * N + n : qw, in);
    } else {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {  // N % 4 == 0: 4-byte words are all in or all out
        const bool in = k < k1 && n + j < N;
        *reinterpret_cast<int*>(dst + j) =
            in ? *reinterpret_cast<const int*>(qw + (size_t)k * N + n + j) : 0;
      }
    }
  }
}

template <int TM>
struct Narrow {
  static_assert(TM == 1 || TM == 2 || TM == 4, "8, 16 or 32 rows a block");
  static constexpr int kBM = TM * 8;
  static constexpr int kWBytes = kNarrowSK * kWLd;
  static constexpr int kStageBytes = kWBytes + kBM * kXLd * 2;
  static constexpr int kSmem = kNarrowStages * kStageBytes;
};

// Grid (row tiles, column tiles, passes x splits); block z takes pass
// z / splits and segments [s_lo, s_lo + segs_per_block) of it. kChain
// (one pass, one split): the block runs the whole fma chain and hands each
// finished pair to epi; else it writes each segment's partial to
// ws[pass][s][m][n] and qmm_reduce_kernel runs the chain.
template <int TM, bool kChain, typename Epi>
__global__ void __launch_bounds__(kNarrowThreads)
qmm_narrow_kernel(const Operands op, const Epi epi, int segs_per_block, int splits, int vec) {
  using C = Narrow<TM>;
  constexpr int kSPS = kSegK / kNarrowSK;
  extern __shared__ __align__(16) uint8_t smem[];
  pdl_release();
  pdl_wait();
  const int M = op.M, K = op.K, N = op.N, gs = op.gs, spg = op.spg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int m_blk = blockIdx.x * C::kBM, n_blk = blockIdx.y * kBlockN;
  const int pass = blockIdx.z / splits;
  const int8_t* __restrict__ qw = pass ? op.w[1] : op.w[0];  // selects: no indexed parameter array
  const float* __restrict__ scales = pass ? op.scales[1] : op.scales[0];
  const int s_lo = (blockIdx.z - pass * splits) * segs_per_block;
  const int n_stages = (min(op.segs, s_lo + segs_per_block) - s_lo) * kSPS;
  const int n_col = n_blk + warp * 16 + 2 * g8;  // this lane's columns n_col, n_col + 1
  const bf16* __restrict__ x = op.x;

  auto load = [&](int c) {
    if (c < n_stages) {
      uint8_t* st = smem + (c % kNarrowStages) * C::kStageBytes;
      const Seg sg = seg_of(s_lo + c / kSPS, gs, spg);
      const int kb = sg.k0 + (c % kSPS) * kNarrowSK;
      load_w(st, qw, kb, sg.k1, n_blk, N, vec, tid);
      bf16* xs = reinterpret_cast<bf16*>(st + C::kWBytes);
      if (tid < C::kBM * (kNarrowSK / 8)) {  // x: BM rows x SK / 8 pieces
        const int r = tid / (kNarrowSK / 8), q = tid % (kNarrowSK / 8);
        load_x8(xs + r * kXLd + q * 8, x, m_blk + r, kb + q * 8, M, K, sg.k1, vec);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };

#pragma unroll
  for (int c = 0; c < kNarrowStages - 1; ++c) load(c);

  float part[TM][4], total[kChain ? TM : 1][4];
  float2 sc = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < (kChain ? TM : 1); ++i) total[i][0] = total[i][1] = total[i][2] = total[i][3] = 0.f;

  for (int c = 0; c < n_stages; ++c) {
    cp_async_wait<kNarrowStages - 2>();  // this thread's pieces of stage c have landed
    __syncthreads();                     // every piece is visible; stage c - 1's readers are done
    const int j = c % kSPS;
    if (j == 0) {
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) part[tm][0] = part[tm][1] = part[tm][2] = part[tm][3] = 0.f;
      if constexpr (kChain) {
        const int g = seg_of(s_lo + c / kSPS, gs, spg).g;
        sc = n_col < N ? __ldg(reinterpret_cast<const float2*>(scales + (size_t)g * N + n_col))
                       : make_float2(0.f, 0.f);
      }
    }
    const uint8_t* st = smem + (c % kNarrowStages) * C::kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(st + C::kWBytes);
    uint32_t a[kNarrowSK / 16][4];
#pragma unroll
    for (int kq = 0; kq < kNarrowSK / 32; ++kq)
      widen_rows32<kWLd>(a[2 * kq], a[2 * kq + 1], st + kq * 32 * kWLd + warp * 16, lane);
    load(c + kNarrowStages - 1);  // into the slot stage c - 1 held
#pragma unroll
    for (int s = 0; s < kNarrowSK / 16; ++s) {
      const int kx = s * 16 + ((lane >> 3) & 1) * 8;
      if constexpr (TM == 1) {
        uint32_t b[2];
        ldsm_x2(b, xs + (lane & 7) * kXLd + kx);
        mma16816(part[0], a[s], b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < TM / 2; ++p) {
          uint32_t b[4];  // b0, b1 of n8 tiles 2p and 2p + 1
          ldsm_x4(b, xs + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * kXLd + kx);
          mma16816(part[2 * p], a[s], b[0], b[1]);
          mma16816(part[2 * p + 1], a[s], b[2], b[3]);
        }
      }
    }
    if (j == kSPS - 1) {  // the segment's partial is complete
      // C rows g8 / g8 + 8 are columns n_col / n_col + 1; C columns 2t4, 2t4 + 1 are rows
      if constexpr (kChain) {
#pragma unroll
        for (int tm = 0; tm < TM; ++tm) {
          total[tm][0] = __fmaf_rn(part[tm][0], sc.x, total[tm][0]);
          total[tm][1] = __fmaf_rn(part[tm][1], sc.x, total[tm][1]);
          total[tm][2] = __fmaf_rn(part[tm][2], sc.y, total[tm][2]);
          total[tm][3] = __fmaf_rn(part[tm][3], sc.y, total[tm][3]);
        }
      } else if (n_col < N) {
        float* wseg = op.ws + ((size_t)pass * op.segs + s_lo + c / kSPS) * M * N;
#pragma unroll
        for (int tm = 0; tm < TM; ++tm) {
          const int m = m_blk + tm * 8 + 2 * t4;
          if (m < M) store2(wseg + (size_t)m * N + n_col, part[tm][0], part[tm][2]);
          if (m + 1 < M) store2(wseg + (size_t)(m + 1) * N + n_col, part[tm][1], part[tm][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kChain) {
    static_assert(!Epi::kStaged, "the narrow chain hands finished pairs to a plain epilogue");
    if (n_col < N) {  // N % 4 == 0: n_col + 1 < N too
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
        const int m = m_blk + tm * 8 + 2 * t4;
        if (m < M) epi.pair(m, n_col, total[tm][0], total[tm][2]);
        if (m + 1 < M) epi.pair(m + 1, n_col, total[tm][1], total[tm][3]);
      }
    }
  } else if constexpr (Epi::kStaged) {
    // The last block of this tile to finish (an integer count of arrivals,
    // no float atomics) runs the ordered chain over every split's partials,
    // then the epilogue: no second launch. The partials it reads were made
    // visible by the other blocks' fences before they arrived.
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* flag = op.flags + blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(flag, 1) == static_cast<int>(gridDim.z) - 1;
      if (last) *flag = 0;  // every block of the tile has arrived: leave it zeroed
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* fin = reinterpret_cast<float*>(smem);  // the ring is free
    for (int i = tid; i < C::kBM * (kBlockN / 2); i += kNarrowThreads) {
      const int r = i / (kBlockN / 2), c = (i % (kBlockN / 2)) * 2;
      const int m = m_blk + r, n = n_blk + c;
      for (int p = 0; p < op.passes; ++p) {
        const float2 t = m < M && n < N ? chain_pair(op, p, m, n) : make_float2(0.f, 0.f);
        store2(fin + p * C::kBM * kFinLd + r * kFinLd + c, t.x, t.y);
      }
    }
    __syncthreads();
    apply_tile<C::kBM, kNarrowThreads>(epi, Fin{fin, C::kBM * kFinLd}, m_blk, min(C::kBM, M - m_blk), n_blk,
                                       N, tid);
  }
}

// ------------------------------------------------ the ordered chain of a split

constexpr int kReduceThreads = 256;
constexpr int kReduceRows = kReduceThreads / (kBlockN / 2);  // 4 rows x 64 column pairs a block

// Grid (row tiles of 4, column tiles of 128). A thread owns two adjacent
// columns of a row and runs the fma chain over the segments' partials in
// segment order, for each pass: the same chain the blocks run in registers
// when K is not split. A staged epilogue then sees the block's tile.
template <typename Epi>
__global__ void __launch_bounds__(kReduceThreads) qmm_reduce_kernel(const Operands op, const Epi epi) {
  __shared__ float fin[Epi::kStaged ? 2 * kReduceRows * kFinLd : 1];
  pdl_release();
  pdl_wait();
  const int M = op.M, N = op.N;
  const int r = threadIdx.x / (kBlockN / 2), c = (threadIdx.x % (kBlockN / 2)) * 2;
  const int m0 = blockIdx.x * kReduceRows, n0 = blockIdx.y * kBlockN;
  const int m = m0 + r, n = n0 + c;
  const bool live = m < M && n < N;  // N % 4 == 0: n + 1 < N too
  for (int pass = 0; pass < op.passes; ++pass) {
    const float2 tot = live ? chain_pair(op, pass, m, n) : make_float2(0.f, 0.f);
    if constexpr (Epi::kStaged) {
      fin[pass * kReduceRows * kFinLd + r * kFinLd + c] = tot.x;
      fin[pass * kReduceRows * kFinLd + r * kFinLd + c + 1] = tot.y;
    } else if (live) {
      epi.pair(m, n, tot.x, tot.y);
    }
  }
  if constexpr (Epi::kStaged) {
    __syncthreads();
    apply_tile<kReduceRows, kReduceThreads>(epi, Fin{fin, kReduceRows * kFinLd}, m0, min(kReduceRows, M - m0),
                                            n0, N, threadIdx.x);
  }
}

// -------------------------------------------------------- M > 32: wgmma

constexpr int kWideConsumers = 256;          // two warpgroups
constexpr int kWideThreads = kWideConsumers + 32;  // and one producer warp
constexpr int kHalfK = 64;  // K rows of a half stage: one box of x, four k16 steps
constexpr int kWideWBytes = kSegK * kBlockN;  // 16 KB: a segment's 128 rows of 128 bytes, swizzled

// A ring stage is one segment: the weight's 128 K rows x 128 columns and x's
// BM rows x 128 K (two boxes of 64). Stages per ring: as many as fit beside
// a parked tile (kPark: the block runs two passes).
template <int BM, bool kPark>
struct Wide {
  static_assert(BM == 64 || BM == 128, "64 or 128 rows of x a block");
  static constexpr int kXHalf = BM * kHalfK * 2;  // BM rows of 128 bytes, swizzled
  static constexpr int kStageBytes = kWideWBytes + 2 * kXHalf;
  static constexpr int kFinBytes = BM * kFinLd * 4;  // a staged tile (a multiple of 1024)
  static constexpr int kParkBytes = kPark ? kFinBytes : 0;
  // the H100's 227 KB a block, less the alignment slack and the barriers
  static constexpr int kStages = (232448 - 1024 - 256 - kParkBytes) / kStageBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static_assert(kFinBytes % 1024 == 0 && kFinBytes <= kRing && kStages >= 3, "the ring and a staged tile fit");
  // [a parked pass's tile] [ring] [barriers]
  static constexpr int kSmem = kParkBytes + kRing + 2 * kStages * 8 + 1024;
};

template <int BM>
__device__ __forceinline__ void wgmma_x(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (BM == 128)
    wgmma_rs_m64n128<0>(d, a, b, scale_d);
  else
    wgmma_rs_m64n64<0>(d, a, b, scale_d);
}

// Grid (row tiles, column tiles, z). kChain: z is 1 and the block runs every
// pass over all segments, the chain in registers; a pass before the last
// parks its finished tile in shared memory (kPark), and the epilogue sees
// every pass's tile (staged) or the finished pairs (plain, one pass). Else
// block z takes pass z / splits and segments [s_lo, s_lo + segs_per_block)
// of it and writes each segment's partial to ws. Warpgroup w owns columns
// 64w..64w+63 of the block's 128 (warp v of it the 16 columns 64w + 16v..,
// its m16 slice of the A tile) and all BM rows. Warp 8 is the producer: its
// lane streams one segment a stage through TMA (the weight's box and x's
// two, in the 128-byte swizzle, zero-filled past the tensors' edges) into a
// ring with a full and an empty mbarrier a slot. A consumer waits a slot's
// full barrier and releases it once a segment; inside, each half's four
// wgmmas run while the next half is widened.
// kPlant (a check of the invariance gate, never launched on the main path):
// the chain runs over the segments in reverse K order.
template <int BM, bool kChain, bool kPlant, bool kPark, typename Epi>
__global__ void __launch_bounds__(kWideThreads, 1)
qmm_wide_kernel(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tx, const Operands op, const Epi epi,
                int segs_per_block, int splits) {
  using C = Wide<BM, kPark>;
  constexpr int kAcc = BM / 2, kStages = C::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  uint8_t* ring = base + C::kParkBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* empty = full + kStages;
  const int pass_lo = kChain ? 0 : blockIdx.z / splits;
  const int pass_hi = kChain ? op.passes : pass_lo + 1;
  const int M = op.M, N = op.N, spg = op.spg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_blk = blockIdx.x * BM, n_blk = blockIdx.y * kBlockN;
  const int s_lo = kChain ? 0 : (blockIdx.z - pass_lo * splits) * segs_per_block;
  const int s_hi = kChain ? op.segs : min(op.segs, s_lo + segs_per_block);
  const int n_stages = (s_hi - s_lo) * (pass_hi - pass_lo);  // 128 | gs here: segment s is K rows 128 s..

  pdl_release();
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWideConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kWideConsumers / 32) {  // the producer
    if (lane == 0) {
      const int per_pass = s_hi - s_lo;
      auto w_of = [&](int c) { return (pass_lo + c / per_pass) ? &tw1 : &tw0; };
      // the weight tiles of the first stages do not wait for the previous launch
      const int pre = min(n_stages, kStages);
      // segment of stage c (the planted fault walks K backwards)
      auto seg = [&](int c) { return kPlant ? s_hi - 1 - c % per_pass : s_lo + c % per_pass; };
      for (int c = 0; c < pre; ++c) {
        mbar_expect_tx(&full[c], C::kStageBytes);
        tma_load_2d(ring + c * C::kStageBytes, w_of(c), n_blk, seg(c) * kSegK, &full[c]);
      }
      pdl_wait();
      for (int c = 0; c < n_stages; ++c) {
        const int slot = c % kStages, s = seg(c);
        uint8_t* st = ring + slot * C::kStageBytes;
        if (c >= kStages) {
          mbar_wait(&empty[slot], (c / kStages - 1) & 1);
          mbar_expect_tx(&full[slot], C::kStageBytes);
          tma_load_2d(st, w_of(c), n_blk, s * kSegK, &full[slot]);
        }
        tma_load_2d(st + kWideWBytes, &tx, s * kSegK, m_blk, &full[slot]);
        tma_load_2d(st + kWideWBytes + C::kXHalf, &tx, s * kSegK + kHalfK, m_blk, &full[slot]);
      }
    }
    return;
  }
  pdl_wait();

  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_col = n_blk + warp * 16 + 2 * g8;  // this lane's columns n_col, n_col + 1
  // the A fragments of a half stage's four k16 steps: ldmatrix.trans of the
  // swizzled int8 tile (row r's 16-byte chunk j sits at chunk j ^ (r % 8))
  auto widen_half = [&](uint32_t (&a)[4][4], int c, int h) {
    const uint8_t* st = ring + (c % kStages) * C::kStageBytes + h * kHalfK * kBlockN;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t r[4];
      ldsm_x4_trans(r, st + (q * 32 + lane) * kBlockN + ((warp ^ (lane & 7)) << 4));
      widen(r[0], a[2 * q][0], a[2 * q][1]);
      widen(r[1], a[2 * q][2], a[2 * q][3]);
      widen(r[2], a[2 * q + 1][0], a[2 * q + 1][1]);
      widen(r[3], a[2 * q + 1][2], a[2 * q + 1][3]);
    }
  };
  // accumulator 4i..4i+3: n8 tile i of rows; C rows g8 / g8 + 8 are columns
  // n_col / n_col + 1, C columns 2t4 / 2t4 + 1 rows 8i + 2t4 / + 1
  auto stage_tile = [&](float* fin, const float (&v)[kAcc]) {
    const int c0 = n_col - n_blk;
#pragma unroll
    for (int i = 0; i < kAcc / 4; ++i) {
      const int r = i * 8 + 2 * t4;
      store2(fin + r * kFinLd + c0, v[4 * i], v[4 * i + 2]);
      store2(fin + (r + 1) * kFinLd + c0, v[4 * i + 1], v[4 * i + 3]);
    }
  };

  float part[kAcc], total[kAcc];  // total unused (and dropped) without kChain
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = total[i] = 0.f;
  uint32_t abuf[2][4][4];
  float2 sc = make_float2(0.f, 0.f);

  mbar_wait(&full[0], 0);
  widen_half(abuf[0], 0, 0);

  // half H of stage c (segment s): its four wgmmas run while the next half
  // is widened (the second half of this stage, or the first of the next,
  // after its full barrier); the segment's partial is chained (or stored)
  // at H = 1
  auto half = [&](auto hh, int c, int s, const float* scales, float* wseg) {
    constexpr int H = decltype(hh)::value;
    if constexpr (H == 0 && kChain) {
      const int g = spg == 1 ? s : s / spg;
      sc = n_col < N ? __ldg(reinterpret_cast<const float2*>(scales + (size_t)g * N + n_col))
                     : make_float2(0.f, 0.f);
    }
    const uint8_t* xs = ring + (c % kStages) * C::kStageBytes + kWideWBytes + H * C::kXHalf;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)  // a k16 step is 32 bytes along the swizzled row
      wgmma_x<BM>(part, abuf[H][t], sw128_desc(xs + t * 32), H == 0 && t == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous half's wgmmas are done: abuf[1 - H] is free
    if constexpr (H == 0) {
      if (c >= 1) {  // the previous stage's slot is read no more
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(c - 1) % kStages]);
      }
      widen_half(abuf[1], c, 1);
    } else {
      if (c + 1 < n_stages) {
        mbar_wait(&full[(c + 1) % kStages], ((c + 1) / kStages) & 1);
        widen_half(abuf[0], c + 1, 0);
      }
      wgmma_wait<0>();
      fence_regs(part);
      if constexpr (kChain) {
#pragma unroll
        for (int i = 0; i < kAcc; i += 4) {
          total[i] = __fmaf_rn(part[i], sc.x, total[i]);
          total[i + 1] = __fmaf_rn(part[i + 1], sc.x, total[i + 1]);
          total[i + 2] = __fmaf_rn(part[i + 2], sc.y, total[i + 2]);
          total[i + 3] = __fmaf_rn(part[i + 3], sc.y, total[i + 3]);
        }
      } else if (n_col < N) {
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i) {
          const int m = m_blk + i * 8 + 2 * t4;
          if (m < M) store2(wseg + (size_t)m * N + n_col, part[4 * i], part[4 * i + 2]);
          if (m + 1 < M) store2(wseg + (size_t)(m + 1) * N + n_col, part[4 * i + 1], part[4 * i + 3]);
        }
      }
    }
  };
  int c = 0;
  for (int pass = pass_lo; pass < pass_hi; ++pass) {
    const float* scales = pass ? op.scales[1] : op.scales[0];
    float* wseg = kChain ? nullptr : op.ws + ((size_t)pass * op.segs + s_lo) * M * N;
    for (int i = 0; i < s_hi - s_lo; ++i, ++c) {
      const int s = kPlant ? s_hi - 1 - i : s_lo + i;  // the planted fault walks K backwards
      half(std::integral_constant<int, 0>{}, c, s, scales, wseg);
      half(std::integral_constant<int, 1>{}, c, s, scales, wseg);
      if constexpr (!kChain) wseg += (size_t)M * N;
    }
    if constexpr (kChain && kPark) {
      if (pass + 1 < pass_hi) {  // park this pass's finished tile, start the next
        stage_tile(reinterpret_cast<float*>(base), total);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) total[i] = 0.f;
      }
    }
  }
  if constexpr (kChain) {
    if constexpr (Epi::kStaged) {
      // every consumer is past its last wgmma: the ring is free for the tile
      consumer_sync();
      stage_tile(reinterpret_cast<float*>(ring), total);
      consumer_sync();
      apply_tile<BM, kWideConsumers>(epi, Fin{reinterpret_cast<const float*>(base), C::kParkBytes / 4}, m_blk,
                                     min(BM, M - m_blk), n_blk, N, tid);
    } else if (n_col < N) {  // N % 4 == 0: n_col + 1 < N too
#pragma unroll
      for (int i = 0; i < kAcc / 4; ++i) {
        const int m = m_blk + i * 8 + 2 * t4;
        if (m < M) epi.pair(m, n_col, total[4 * i], total[4 * i + 2]);
        if (m + 1 < M) epi.pair(m + 1, n_col, total[4 * i + 1], total[4 * i + 3]);
      }
    }
  }
}

// ------------------------------------------------------------- launches

// The dynamic shared memory a kernel may take, raised as a launch needs it.
// Kept by the kernel's address: a function-local static of an inline
// template is one object across every library loaded in the process (three
// include this header), so a plain flag set for one library's kernel would
// stand for another's.
template <typename Kern>
int smem_for(Kern* kern, int bytes) {
  static const void* seen[16];
  static int set[16], n = 0;
  int i = 0;
  while (i < n && seen[i] != reinterpret_cast<const void*>(kern)) ++i;
  if (i < n && set[i] >= bytes) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc == 0 && i < 16) {
    seen[i] = reinterpret_cast<const void*>(kern);
    set[i] = bytes;
    n = i == n ? n + 1 : n;
  }
  return rc;
}

// The plan of a call: bm rows of x a block (8, 16 or 32: mma.sync; 64 or
// 128: wgmma) and the splits of K over blocks (1: the chain in registers,
// one pass at a time for mma.sync).
// A kernel's launch, with programmatic dependent launch when pdl is set;
// returns the launch's error.
template <typename... KArgs, typename... Args>
int launch_k(void (*kern)(KArgs...), dim3 grid, int threads, int smem, cudaStream_t s, bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int TM, bool kChain, typename Epi>
int launch_narrow(const Operands& op, const Epi& epi, int splits, int vec, cudaStream_t s, bool pdl = false) {
  using C = Narrow<TM>;
  auto* kern = qmm_narrow_kernel<TM, kChain, Epi>;
  if (const int rc = smem_for(kern, C::kSmem)) return rc;
  const int per = (op.segs + splits - 1) / splits;
  splits = (op.segs + per - 1) / per;
  const dim3 grid((op.M + C::kBM - 1) / C::kBM, (op.N + kBlockN - 1) / kBlockN,
                  kChain ? 1 : op.passes * splits);
  return launch_k(kern, grid, kNarrowThreads, C::kSmem, s, pdl, op, epi, per, splits, vec);
}

template <typename Epi>
int launch_reduce(const Operands& op, const Epi& epi, cudaStream_t s, bool pdl = false) {
  const dim3 grid((op.M + kReduceRows - 1) / kReduceRows, (op.N + kBlockN - 1) / kBlockN);
  return launch_k(qmm_reduce_kernel<Epi>, grid, kReduceThreads, 0, s, pdl, op, epi);
}

template <int BM, bool kChain, bool kPlant = false, bool kPark = false, typename Epi>
int launch_wide(const Operands& op, const Epi& epi, int splits, cudaStream_t s, bool pdl = false) {
  using C = Wide<BM, kPark>;
  auto* kern = qmm_wide_kernel<BM, kChain, kPlant, kPark, Epi>;
  if (const int rc = smem_for(kern, C::kSmem)) return rc;
  CUtensorMap tw[2], tx;
  const uint64_t dw[2] = {(uint64_t)op.N, (uint64_t)op.K}, dx[2] = {(uint64_t)op.K, (uint64_t)op.M};
  const uint32_t bw = kSegK, bx = BM;  // rows of a box (of 128 bytes each)
  for (int p = 0; p < 2; ++p)
    if (const int rc = make_map(&tw[p], op.w[p < op.passes ? p : 0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2,
                                dw, &bw))
      return rc;
  if (const int rc = make_map(&tx, op.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dx, &bx)) return rc;
  const int per = (op.segs + splits - 1) / splits;
  splits = (op.segs + per - 1) / per;
  // row tiles fastest: the blocks of a column tile run together and share its weight in L2
  const dim3 grid((op.M + BM - 1) / BM, (op.N + kBlockN - 1) / kBlockN, kChain ? 1 : op.passes * splits);
  return launch_k(kern, grid, kWideThreads, C::kSmem, s, pdl, tw[0], tw[1], tx, op, epi, per, splits);
}

// the chain in registers: the plant and the parked pass picked at compile
// time (a staged epilogue says how many passes it takes, kPasses; a parked
// call is never planted)
template <int BM, typename Epi>
int launch_chain(const Operands& op, const Epi& epi, int plant, cudaStream_t s) {
  if constexpr (Epi::kPasses > 1) {
    if (op.passes > 1) return launch_wide<BM, true, false, true>(op, epi, 1, s, true);  // not planted
  }
  return plant ? launch_wide<BM, true, true>(op, epi, 1, s, true) : launch_wide<BM, true>(op, epi, 1, s, true);
}

// Whether a shape can take the wgmma path: TMA's 16-byte rows (N % 16, and
// x's K % 8, which 128 | gs gives) and whole 128-row segments.
inline bool wide_ok(const Operands& op, int vec) { return vec && op.gs % kSegK == 0; }

// A call on a staged epilogue (the fused layer): bm 8/16/32 runs mma.sync,
// writes the segment partials whatever the splits, and a tile's last block
// runs the chain and the epilogue (op.flags); bm 64/128 runs wgmma, the
// chain in registers at one split, else partials and qmm_reduce_kernel.
// One or two launches in stream order, each with programmatic dependent
// launch.
template <typename Epi>
int run_product(const Operands& op, const Epi& epi, int bm, int splits, int plant, cudaStream_t s) {
  const int vec = op.N % 16 == 0 && op.gs % 8 == 0;
  if (bm > 32 && wide_ok(op, vec)) {
    if (splits == 1) return bm == 64 ? launch_chain<64>(op, epi, plant, s) : launch_chain<128>(op, epi, plant, s);
    const int rc = bm == 64 ? launch_wide<64, false>(op, NoEpi{}, splits, s, true)
                            : launch_wide<128, false>(op, NoEpi{}, splits, s, true);
    if (rc) return rc;
    return launch_reduce(op, epi, s, true);
  }
  // mma.sync: the last block of a tile runs the chain and the epilogue
  return bm <= 8    ? launch_narrow<1, false>(op, epi, splits, vec, s, true)
         : bm <= 16 ? launch_narrow<2, false>(op, epi, splits, vec, s, true)
                    : launch_narrow<4, false>(op, epi, splits, vec, s, true);
}

}  // namespace ds_qmm
