// w8a16 quantized matmul on Hopper's tensor cores: out = x @ dequant(qw, scales).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quant_matmul.py::_qmm_kernel.
// Same arithmetic: int8 weights widen to bf16 in registers (the bf16 weight
// never exists in memory), products accumulate in fp32 per quantization
// group, and each group's partial sum is multiplied by that group's fp32
// scale row, the scaled partials added in group order.
//
// Layout (the JAX one): x (M, K) bf16 row-major; qw (K, N) int8; scales
// (G, N) fp32 with group size gs = K / G; out (M, N) bf16 or fp32.
//
// What bounds it on the H100: at decode (M = 8) the weight bytes, K*N, over
// 3.35 TB/s (the 2*M*K*N operations are a few hundredths of that); at
// prefill (M = 1024) the 2*M*K*N operations over the 989 TFLOP/s of the bf16
// tensor cores.
//
// Design. Both paths compute out^T = W^T x^T: N lies on the tensor core's
// row side (the A operand, the widened weight, from registers) and M on its
// column side (the B operand, x, from shared memory). A warp reads 32 K rows
// x 16 columns of the stage's int8 weight tile with one ldmatrix.trans (b16
// units, so a lane gets two K rows of a column pair) and widens the bytes in
// registers into the A fragments of two k16 steps (integer masks and one
// bf16x2 subtraction per pair, exact): column 2g of the warp's 16 is A row
// g, column 2g + 1 row g + 8, on both paths.
//   M > 32 (prefill, chunk steps): wgmma m64n128k16, A from registers. A
// block is two consumer warpgroups and a producer warp, 128 columns x 128
// rows of x; a warpgroup's four warps hold its 64 columns' A tile, and all
// 128 rows of x are the wgmma's n. The producer streams K through a ring of
// 6 stages of 64 rows with TMA (the int8 tile and x's tile both in the
// 128-byte swizzle, zero-filled past the tensors' edges; a full and an
// empty mbarrier per slot, no block-wide barrier in the loop). A stage's
// four wgmmas run while the next stage's int8 tile is widened. The weight
// is read and widened once per 128 rows of x. TMA wants 16-byte rows and
// the ring whole 128-row segments: a shape with N % 16 or gs % 128 runs the
// M <= 32 path at every M.
//   M <= 32 (decode, verify): mma.sync m16n8k16 (the same 16-term products
// into fp32). A block's 8 warps each own 16 of its 128 columns and 8, 16 or
// 32 rows; K streams through a ring of 6 stages of 64 rows (cp.async,
// zero-filled past the edges), and K is split over blocks so that about
// two blocks per SM stream weight bytes.
//
// The sum. K is cut into segments of at most 128 rows that never cross a
// quantization group (a group of 128 is one segment). A segment's product
// starts from zero and runs over its k16 steps in K order; then
// total = fma(partial, scale[group][n], total), segment after segment in K
// order, from total = 0. The scale distributes over a group's segments.
//
// Batch invariance: a row's bits depend on (K, N, G) alone, never on M.
// Every M runs the same segment partials (16-term tensor-core products in
// the same K order, a column and a row at fixed places of their tiles) and
// the same fma chain. wgmma m64n128k16 and mma.sync m16n8k16 give the same
// bits for the same products: held on the card by the invariance checks
// (rows of M = 1, 8, 16, 32 against M = 33, 64, 65, 512, 1024 at gpt2-large's and
// llama3-8b's shapes, in chip_smoke.py and tests/test_torch_kernels_cuda.py),
// not assumed. What follows M is only which instruction and how many rows a
// warp takes, and where the chain runs: in registers, or, where K is split
// over blocks (M <= 32), each segment's partial goes to a workspace and a
// second launch (qmm_reduce_kernel) runs the same fma chain over the
// segments in order. No atomics and no fence: two calls give the same bits.

#include <type_traits>

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace {

using ds_mma::bf16;
using ds_mma::mma16816;
using ds_mma::smem_u32;
using namespace ds_hopper;
using namespace ds_int8;

constexpr int kSegK = 128;   // K rows of a segment
constexpr int kBlockN = 128; // columns of a block, both paths
constexpr int kWLd = kBlockN + 16;  // int8 stage row stride: 8 ldmatrix rows in distinct banks

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

// kChain: the block runs the whole fma chain over its segments (all of K)
// and writes out; else it writes each segment's partial to ws[s][m][n] and
// qmm_reduce_kernel runs the chain.
template <int TM, typename OutT, bool kChain>
__global__ void __launch_bounds__(kNarrowThreads)
qmm_narrow_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw,
                  const float* __restrict__ scales, OutT* __restrict__ out, float* __restrict__ ws,
                  int M, int K, int N, int gs, int spg, int segs, int segs_per_block, int vec) {
  using C = Narrow<TM>;
  constexpr int kSPS = kSegK / kNarrowSK;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int m_blk = blockIdx.x * C::kBM, n_blk = blockIdx.y * kBlockN;
  const int s_lo = blockIdx.z * segs_per_block;
  const int n_stages = (min(segs, s_lo + segs_per_block) - s_lo) * kSPS;
  const int n_col = n_blk + warp * 16 + 2 * g8;  // this lane's columns n_col, n_col + 1

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
        float* wseg = ws + (size_t)(s_lo + c / kSPS) * M * N;
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
    if (n_col < N) {  // N % 4 == 0: n_col + 1 < N too
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
        const int m = m_blk + tm * 8 + 2 * t4;
        if (m < M) store2(out + (size_t)m * N + n_col, total[tm][0], total[tm][2]);
        if (m + 1 < M) store2(out + (size_t)(m + 1) * N + n_col, total[tm][1], total[tm][3]);
      }
    }
  }
}

constexpr int kReduceThreads = 256;

// The second launch of a split K: a thread owns two adjacent columns of a
// row and runs the fma chain over the segments' partials in segment order,
// the same chain the blocks run in registers when K is not split.
template <typename OutT>
__global__ void __launch_bounds__(kReduceThreads)
qmm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scales,
                  OutT* __restrict__ out, int M, int N, int spg, int segs) {
  const int pairs = N / 2;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= M * pairs) return;
  const int m = i / pairs, n = (i - m * pairs) * 2;
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
  store2(out + (size_t)m * N + n, tot.x, tot.y);
}

// -------------------------------------------------------- M > 32: wgmma

constexpr int kWideConsumers = 256;          // two warpgroups
constexpr int kWideThreads = kWideConsumers + 32;  // and one producer warp
constexpr int kWideStages = 6;
constexpr int kWideSK = 64;   // K rows of a stage (half a segment)
constexpr int kWideBM = 128;  // rows of x a block: the wgmma's n
constexpr int kWideWBytes = kWideSK * kBlockN;     // 8 KB: 64 rows of 128 bytes, swizzled
constexpr int kWideXBytes = kWideBM * kWideSK * 2;  // 16 KB: 128 rows of 128 bytes, swizzled
constexpr int kWideStageBytes = kWideWBytes + kWideXBytes;
constexpr int kWideSmem = kWideStages * kWideStageBytes + 2 * kWideStages * 8 + 1024;  // + barriers, alignment

// Warpgroup w owns columns 64w..64w+63 of the block's 128 (warp v of it the
// 16 columns 64w + 16v.., its m16 slice of the A tile) and all 128 rows.
// Warp 8 is the producer: one lane streams the stages through TMA (the
// weight tile as 64 rows of 128 bytes, x's as 128 rows of 64 bf16, both in
// the 128-byte swizzle, zero-filled past the tensors' edges) into a ring of
// kWideStages slots, each with a full and an empty barrier.
template <typename OutT>
__global__ void __launch_bounds__(kWideThreads, 1)
qmm_wide_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                const float* __restrict__ scales, OutT* __restrict__ out, int M, int N, int spg,
                int segs) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWideStages * kWideStageBytes);
  uint64_t* empty = full + kWideStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_blk = blockIdx.x * kWideBM, n_blk = blockIdx.y * kBlockN;
  const int n_stages = segs * 2;  // 128 | gs here: stage c is K rows 64c..64c+63

  if (tid == 0) {
    for (int i = 0; i < kWideStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWideConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kWideConsumers / 32) {  // the producer
    if (lane == 0) {
      for (int c = 0; c < n_stages; ++c) {
        const int slot = c % kWideStages;
        if (c >= kWideStages) mbar_wait(&empty[slot], (c / kWideStages - 1) & 1);
        uint8_t* st = smem + slot * kWideStageBytes;
        mbar_expect_tx(&full[slot], kWideStageBytes);
        tma_load_2d(st, &tw, n_blk, c * kWideSK, &full[slot]);
        tma_load_2d(st + kWideWBytes, &tx, c * kWideSK, m_blk, &full[slot]);
      }
    }
    return;
  }

  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_col = n_blk + warp * 16 + 2 * g8;  // this lane's columns n_col, n_col + 1
  // the A fragments of a stage's four k16 steps: ldmatrix.trans of the
  // swizzled int8 tile (row r's 16-byte chunk j sits at chunk j ^ (r % 8))
  auto widen_stage = [&](uint32_t (&a)[4][4], int c) {
    const uint8_t* st = smem + (c % kWideStages) * kWideStageBytes;
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

  float part[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = total[i] = 0.f;
  uint32_t abuf[2][4][4];
  float2 sc = make_float2(0.f, 0.f);

  mbar_wait(&full[0], 0);
  widen_stage(abuf[0], 0);

  // stage c, the half P of its segment: its four wgmmas run while the next
  // stage is widened; the segment's partial is chained at P = 1
  auto stage = [&](auto half, int c) {
    constexpr int P = decltype(half)::value;
    if constexpr (P == 0) {
      const int g = spg == 1 ? c >> 1 : (c >> 1) / spg;
      sc = n_col < N ? __ldg(reinterpret_cast<const float2*>(scales + (size_t)g * N + n_col))
                     : make_float2(0.f, 0.f);
    }
    const uint8_t* xs = smem + (c % kWideStages) * kWideStageBytes + kWideWBytes;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t)  // a k16 step is 32 bytes along the swizzled row
      wgmma_m64n128(part, abuf[P][t], sw128_desc(xs + t * 32), P == 0 && t == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // stage c - 1's wgmmas are done: its slot and abuf[1 - P] are free
    if (c >= 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(c - 1) % kWideStages]);
    }
    if (c + 1 < n_stages) {
      mbar_wait(&full[(c + 1) % kWideStages], ((c + 1) / kWideStages) & 1);
      widen_stage(abuf[1 - P], c + 1);
    }
    if constexpr (P == 1) {
      wgmma_wait<0>();
      fence_regs(part);
      // accumulator 4i..4i+3: n8 tile i of rows; C rows g8 / g8 + 8 are columns n_col / n_col + 1
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        total[i] = __fmaf_rn(part[i], sc.x, total[i]);
        total[i + 1] = __fmaf_rn(part[i + 1], sc.x, total[i + 1]);
        total[i + 2] = __fmaf_rn(part[i + 2], sc.y, total[i + 2]);
        total[i + 3] = __fmaf_rn(part[i + 3], sc.y, total[i + 3]);
      }
    }
  };
  for (int c = 0; c < n_stages; c += 2) {
    stage(std::integral_constant<int, 0>{}, c);
    stage(std::integral_constant<int, 1>{}, c + 1);
  }
  if (n_col < N) {  // N % 4 == 0: n_col + 1 < N too
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = m_blk + i * 8 + 2 * t4;
      if (m < M) store2(out + (size_t)m * N + n_col, total[4 * i], total[4 * i + 2]);
      if (m + 1 < M) store2(out + (size_t)(m + 1) * N + n_col, total[4 * i + 1], total[4 * i + 3]);
    }
  }
}

// ------------------------------------------------------------- launches

struct Args {
  const bf16* x;
  const int8_t* qw;
  const float* scales;
  void* out;
  float* ws;
  int M, K, N, gs, spg, segs, splits, vec;
  cudaStream_t s;
};

template <int TM, typename OutT, bool kChain>
int launch_narrow_main(const Args& a, int splits) {
  using C = Narrow<TM>;
  auto* kern = qmm_narrow_kernel<TM, OutT, kChain>;
  static bool attr = false;
  if (const int rc = set_smem(kern, C::kSmem, attr)) return rc;
  const int per = (a.segs + splits - 1) / splits;
  const dim3 grid((a.M + C::kBM - 1) / C::kBM, (a.N + kBlockN - 1) / kBlockN, (a.segs + per - 1) / per);
  kern<<<grid, kNarrowThreads, C::kSmem, a.s>>>(a.x, a.qw, a.scales, static_cast<OutT*>(a.out), a.ws,
                                                a.M, a.K, a.N, a.gs, a.spg, a.segs, per, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// K split over `splits` blocks (a workspace and the ordered second launch)
// or, with one split, the chain in registers
template <int TM, typename OutT>
int launch_narrow(const Args& a) {
  if (a.splits == 1) return launch_narrow_main<TM, OutT, true>(a, 1);
  if (const int rc = launch_narrow_main<TM, OutT, false>(a, a.splits)) return rc;
  const int threads = a.M * (a.N / 2);
  qmm_reduce_kernel<OutT><<<(threads + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, a.s>>>(
      a.ws, a.scales, static_cast<OutT*>(a.out), a.M, a.N, a.spg, a.segs);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_wide(const Args& a) {
  static bool attr = false;
  if (const int rc = set_smem(qmm_wide_kernel<OutT>, kWideSmem, attr)) return rc;
  CUtensorMap tw, tx;
  const uint64_t dw[2] = {(uint64_t)a.N, (uint64_t)a.K}, dx[2] = {(uint64_t)a.K, (uint64_t)a.M};
  const uint32_t bw = kWideSK, bx = kWideBM;  // rows of a box (of 128 bytes each)
  if (const int rc = make_map(&tw, a.qw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, dw, &bw)) return rc;
  if (const int rc = make_map(&tx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dx, &bx)) return rc;
  // row tiles fastest: the blocks of a column tile run together and share its weight in L2
  const dim3 grid((a.M + kWideBM - 1) / kWideBM, (a.N + kBlockN - 1) / kBlockN);
  qmm_wide_kernel<OutT><<<grid, kWideThreads, kWideSmem, a.s>>>(tw, tx, a.scales, static_cast<OutT*>(a.out),
                                                               a.M, a.N, a.spg, a.segs);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(const Args& a) {
  if (a.M <= 8) return launch_narrow<1, OutT>(a);
  if (a.M <= 16) return launch_narrow<2, OutT>(a);
  // the wide path's TMA boxes want 16-byte rows (N % 16, K % 8) and whole
  // 128-row segments; any other shape runs the narrow path at every M
  if (a.M <= 32 || !a.vec || a.gs % kSegK) return launch_narrow<4, OutT>(a);
  return launch_wide<OutT>(a);
}

}  // namespace

// x, qw, scales, out: device pointers; the caller checked shapes, types,
// contiguity, N % 4 == 0 and 16-byte alignment. ``splits``: the blocks K
// is split over at M <= 32 (1 at larger M), ws then holding
// segments * M * N floats, segments = G * ceil((K / G) / 128); else ws may
// be null. One or two launches on ``stream``; returns the first
// cudaGetLastError() (or attribute error) that is not 0.
DS_EXPORT int qmm_launch(const void* x, const void* qw, const void* scales, void* out, void* ws,
                         int M, int K, int N, int G, int splits, int out_f32, void* stream) {
  const int gs = K / G;
  const int spg = (gs + kSegK - 1) / kSegK;
  const Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(qw),
               static_cast<const float*>(scales), out, static_cast<float*>(ws), M, K, N, gs, spg,
               G * spg, splits, N % 16 == 0 && gs % 8 == 0, static_cast<cudaStream_t>(stream)};
  return out_f32 ? launch<float>(a) : launch<bf16>(a);
}
