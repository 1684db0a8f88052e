// The three w8a16 / w8a8 tilings of the decode-shape microbench on Hopper:
// out (M, N) fp32 = sum over groups g of part_g * scale, where part_g is
// the product of x's and W's rows of quantization group g.
//
// Replaces the TPU kernels of benchmarks/qmm_microbench.py:
//   kQmm2 <- _qmm2_kernel: the int8 tile widened to bf16 before the dot;
//   kQmm3 <- _qmm3_kernel: the same function, the s8 operand handed to the
//            dot (no widened copy of the tile);
//   kQmm4 <- _qmm4_kernel: w8a8, an int8 x int8 dot in int32 per group,
//            scaled by the row's activation scale times the group's; the
//            row quantization, outside pallas_call in JAX, is inside here.
//
// Layout (the JAX one): x (M, K) bf16; qw (K, N) int8; scales (G, N) fp32,
// group size gs = K / G; out (M, N) fp32.
//
// What bounds it on the H100: at the bench's decode shape (M 8, K 1280,
// N 5120) the 6.55 MB of int8 weight bytes over 3.35 TB/s, about 2 us; the
// 2*M*K*N multiply-adds are 0.1 us even at the bf16 tensor-core rate, so
// wgmma buys nothing. In practice three things set the time, and the design
// answers each:
//   - bytes in flight: one launch whose grid fills the card, each CTA's
//     whole walk of weight boxes issued at once;
//   - the SM's instruction issue: every byte is handled once or twice on
//     its way to the tensor cores, and 16 warps share an SM's 4 schedulers,
//     so a step of 512 weight bytes must cost tens of instructions, not
//     hundreds: no division in the walk, steps in pairs with two
//     accumulators, int8 widened with integer ops, not conversions;
//   - the start: a TMA copy takes ~0.1 us to issue on the H100, so x comes
//     in one copy, and box 0 goes before the cluster's set-up.
// The three modes differ only in what happens to a weight byte once it is
// in shared memory, which is the question the bench asks:
//   qmm2: each lane widens one K row of the step (16 bytes) into the warp's
//         bf16 copy in shared memory, and ldmatrix.trans reads bf16 A
//         fragments from it for mma.sync m16n8k16 (fp32 sums);
//   qmm3: no bf16 copy: ldmatrix.trans reads the int8 box's bytes in b16
//         units straight into registers, where they are widened right
//         before the same bf16 mma. Hopper has no mixed bf16 x s8 MMA, so
//         this is its counterpart of handing the s8 operand to the dot;
//   qmm4: the int8 bytes from ldmatrix.trans are byte-permuted into s8 A
//         fragments for mma.sync m16n8k32 .s32.s8.s8.s32 (int32 sums, exact).
//
// Design: one launch, no workspace. A CTA owns a strip of 32 columns and one
// tile of 8 rows of x, and walks all of K for it: 160 CTAs at the bench's
// shape, the least shared memory, and a width that divides every N the JAX
// code takes (block_n is a multiple of 128 and divides N). Wider strips (64,
// 128 columns) were measured slower at the bench's shape (PERF.md); the JAX
// block_n sets nothing here. The ring's depth comes from K on the host
// (ops/qmm_microbench.py::_grid). Weight bytes come by TMA in 8 KB boxes (32
// columns by 256 K rows, 32-byte swizzle so that ldmatrix on the narrow
// rows meets no bank conflict) into a ring of up to 5 stages: the
// whole 40 KB strip is in flight at once at the bench's shape. The last warp
// done with a box refills its stage (a counter in shared memory; its reads
// are ordered before the count). x's 8 rows land once, in 1 KB slabs of 64
// columns (128-byte swizzle, conflict-free ldmatrix for the B fragments);
// the CTAs of a cluster (4 along N) share the row tile, and each loads a
// quarter of the slabs into all of them (TMA multicast). qmm4 then quantizes
// the rows, a warp a row: sx = max|x| / 127 + 1e-12 and xq = clip(rint(x /
// sx)), bitwise the wrapper's quantize_rows (x * (1 / sx) where that cannot
// change the rounding, the exact quotient near a half-integer).
// M = 8 fills half of an m16 tile, so the kernel computes the transposed
// product out^T = W^T x^T: a 16-column tile of the strip takes the m16 side
// and the 8 rows of x are exactly n8. The 8 warps split the strip's tiles,
// and the groups of a tile go round robin to the warps that share it: each
// group's raw partial is one warp's sum of its steps (two chains, added at
// the group's end). The warp multiplies it by the group's scales (qmm4:
// float(part) * (sx[m] * s[g, n])) and stores the product in shared memory;
// after the walk one warp a tile adds the products in group order, acc =
// acc + product_g, each product and sum rounded once (__fmul_rn /
// __fadd_rn) as the plain version does. No atomics on the data and a fixed
// order: two calls are bitwise equal, and qmm4's exact int32 partials make
// it bitwise its plain version.
//
// ldmatrix.trans on int8 (qmm3, qmm4): each 8 x 8 b16 matrix is 8 K rows of
// 16 bytes (16 columns); a lane receives K rows 2t, 2t+1 of the column PAIR
// (2g, 2g+1): bytes (k 2t, n 2g), (k 2t, n 2g+1), (k 2t+1, n 2g),
// (k 2t+1, n 2g+1). Bytes 0 and 2 are one column and two K rows, which is a
// bf16 A fragment register after widening; so the mma's row g is column 2g
// and its row g + 8 is column 2g + 1. For m16n8k32 a register holds 4 K
// values of one row: the K order inside the 32-row step is permuted
// (kappa 4t..4t+3 <-> k 2t, 2t+1, 8+2t, 9+2t), and xq is stored in the same
// order, which leaves the integer dot unchanged.

#include <type_traits>

#include "hopper.cuh"

namespace {

using ds_hopper::fence_mbar_init;
using ds_hopper::mbar_expect_tx;
using ds_hopper::mbar_init;
using ds_hopper::mbar_wait;
using ds_hopper::tma_load_2d;
using ds_mma::bf16;
using ds_mma::ldsm_x4;
using ds_mma::mma16816;
using ds_mma::smem_u32;

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsM = 8;          // rows of x a CTA (the mma's n8)
constexpr int kW = 32;             // columns of a CTA's strip
constexpr int kCluster = 4;        // CTAs of a cluster along N, sharing x's rows
constexpr int kBoxBytes = 8192;    // a weight box: kW columns x kRows K rows
constexpr int kRows = kBoxBytes / kW;
constexpr int kTiles = kW / 16;    // 16-column tiles of the strip
constexpr int kShare = kWarps / kTiles;  // warps sharing a tile
constexpr int kXBox = 1024;        // an x box: 64 bf16 columns (128 bytes) x 8 rows
constexpr int kPrivLd = 24;        // bf16 row stride of qmm2's per-warp copy (conflict-free ldmatrix)
constexpr int kPriv = 2 * 32 * kPrivLd * 2;  // a warp's copies of a pair of 32 x 16 steps, bytes
constexpr int kMaxSmem = 232448;   // the most dynamic shared memory a block may take
constexpr int kSmemAlign = 1024;   // the boxes start on 1024-byte boundaries

enum Mode { kQmm2 = 0, kQmm3 = 1, kQmm4 = 2 };

// x's 1 KB slabs (64 columns by the 8 rows) a CTA of a cluster loads for
// all of them (K is a multiple of 64)
__host__ __device__ inline int x_slabs(int K) { return (K / 64 + kCluster - 1) / kCluster; }

// Shared memory of a CTA (byte offsets from the 1024-byte aligned base). The
// host's figure (ops/qmm_microbench.py::_smem_bytes) is what the launch
// gives; the launch refuses one below `bytes`.
struct Layout {
  int ring, xs, priv, xq, prods, sx, cnt, bars, bytes;
  __host__ __device__ Layout(int mode, int K, int G, int stages) {
    int at = 0;
    ring = at, at += stages * kBoxBytes;
    xs = at, at += x_slabs(K) * kCluster * kXBox;
    priv = at, at += mode == kQmm2 ? kWarps * kPriv : 0;
    xq = at, at += mode == kQmm4 ? kRowsM * (K + 16) : 0;
    prods = at, at += G * kW * 32;  // a group's scaled partials, mma layout, per 16-column tile
    sx = at, at += kRowsM * 4;
    cnt = at, at += stages * 4;
    bars = (at + 7) / 8 * 8, at = bars + (stages + 1) * 8;
    bytes = at + kSmemAlign;
  }
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 s32) += a (16x32 s8) b (32x8 s8)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the signed bytes at bits 0-7 and 16-23 of v as a bf16 pair, exactly: the
// low 7 bits make 128 + (u & 127) and the sign bit 128 or 256, one bf16
// subtraction apart (two LOP3 and a SUB: no quarter-rate conversion)
__device__ __forceinline__ uint32_t s8pair_bf16(uint32_t v) {
  const uint32_t m = (v & 0x007F007Fu) | 0x43004300u, s = (v & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(m), "r"(s));
  return d;
}

// a box of a 3D tensor map into the same shared-memory offset of every CTA
// of the cluster in `mask`, completing on each one's barrier at bar's offset
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const void* map, int c0, int c1, int c2,
                                                      uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1, "
      "{%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// TMA's 32-byte swizzle of a box with 32-byte rows: row r's 16-byte piece c
// lies at piece c ^ swz(r)
__device__ __forceinline__ int swz(int r) { return (r >> 2) & 1; }
// x (m, k) in its TMA boxes: 64 columns (128 bytes) a box, 128-byte swizzle
__device__ __forceinline__ int x_off(int m, int k) {
  return (k >> 6) * kXBox + m * 128 + ((((k >> 3) & 7) ^ m) << 4) + (k & 7) * 2;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
           const float* __restrict__ scales, float* __restrict__ out, int M, int K, int N, int G,
           int stages, int plant) {
  static_assert(kWarps == kRowsM, "the quantization pass takes a row a warp");

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((kSmemAlign - (smem_u32(smem_raw) & (kSmemAlign - 1))) & (kSmemAlign - 1));
  const Layout lay(kMode, K, G, stages);
  uint8_t* ring = base + lay.ring;
  const uint8_t* xs = base + lay.xs;
  int8_t* xq = reinterpret_cast<int8_t*>(base + lay.xq);
  float4* prods = reinterpret_cast<float4*>(base + lay.prods);
  float* sxs = reinterpret_cast<float*>(base + lay.sx);
  int* cnt = reinterpret_cast<int*>(base + lay.cnt);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* xbar = full + stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xqld = K + 16;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kW, m0 = blockIdx.y * kRowsM;
  const int rows = min(kRowsM, M - m0);
  const int gs = K / G, boxes = (K + kRows - 1) / kRows, slabs = x_slabs(K);

  // box b into stage b % stages (rows past K fill zeros)
  auto issue = [&](int b) {
    const int s = b % stages;
    mbar_expect_tx(&full[s], kBoxBytes);
    tma_load_2d(ring + s * kBoxBytes, &tw, n0, b * kRows, &full[s]);
  };
  const int rank = cluster_rank();
  if (tid == 0) {
    // the maps' first reads overlap the set-up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1), cnt[s] = 0;
    mbar_init(xbar, 1);
    fence_mbar_init();
    issue(0);  // the first weight box ahead of the cluster's set-up
  }
  // every barrier of the cluster is set up before a peer signals it
  cluster_arrive();
  cluster_wait();
  if (tid == 0) {
    // x's 8 rows (rows past M fill zeros), once, ahead of the weights: every
    // step needs them. One copy a CTA: the CTAs of a cluster share the row
    // tile, and each loads its run of slabs into all of them.
    mbar_expect_tx(xbar, slabs * kCluster * kXBox);
    tma_load_3d_multicast(base + lay.xs + rank * slabs * kXBox, &tx, 0, m0, rank * slabs, xbar,
                          static_cast<uint16_t>((1u << kCluster) - 1));
    for (int b = 1; b < min(stages, boxes); ++b) issue(b);
  }
  mbar_wait(xbar, 0);

  if constexpr (kMode == kQmm4) {
    // the rows' dynamic quantization, bitwise quantize_rows (fp32 division,
    // ties to even, then the clip), a warp a row. xq is kept in the mma's K
    // order (k 2t, 2t+1, 8+2t, 9+2t in byte 4t of each 16-byte half of a
    // 32-row step), so that ldmatrix hands over the B fragments as they are:
    // a word is those 4 values of the row.
    float mx = 0.f;
    for (int j = lane; j < K / 8; j += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(xs + x_off(warp, 8 * j));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mx = fmaxf(mx, fmaxf(fabsf(__uint_as_float(w[q] << 16)), fabsf(__uint_as_float(w[q] & 0xFFFF0000u))));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float sx = __fadd_rn(__fdiv_rn(mx, 127.f), 1e-12f), rx = __frcp_rn(sx);
    if (lane == 0) sxs[warp] = sx;
    for (int wd = lane; wd < K / 4; wd += 32) {
      const int k = (wd >> 3) * 32 + ((wd >> 2) & 1) * 16 + 2 * (wd & 3);
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(xs + x_off(warp, k));
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(xs + x_off(warp, k + 8));
      const float v[4] = {__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u), __uint_as_float(hi << 16),
                          __uint_as_float(hi & 0xFFFF0000u)};
      // x * (1 / sx) is within 2^-15 of the rounded quotient (|x / sx| <=
      // 127): where it lies 2^-12 or more from a half-integer both round to
      // the same integer; nearer, the quotient is taken exactly. The clip,
      // then rint (ties to even: adding 1.5 * 2^23 rounds there), leaves
      // the integer in the low byte of the sum's bits.
      float u[4];
      bool near = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float t = __fmul_rn(v[q], rx);
        u[q] = __fadd_rn(fminf(fmaxf(t, -127.f), 127.f), 12582912.f);
        near |= fabsf(__fsub_rn(t, __fsub_rn(u[q], 12582912.f))) > 0.5f - 0x1p-12f;
      }
      if (near) {
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = __fadd_rn(fminf(fmaxf(__fdiv_rn(v[q], sx), -127.f), 127.f), 12582912.f);
      }
      *reinterpret_cast<uint32_t*>(xq + warp * xqld + 4 * wd) =
          __byte_perm(__byte_perm(__float_as_uint(u[0]), __float_as_uint(u[1]), 0x0040),
                      __byte_perm(__float_as_uint(u[2]), __float_as_uint(u[3]), 0x0040), 0x5410);
    }
    __syncthreads();
  }

  // the warp's 16-column tile and its share of the tile's groups (g = wq,
  // wq + kShare, ...): each group's raw partial is one chain of mma steps
  const int nt = warp % kTiles, wq = warp / kTiles;
  const int n_lo = nt * 16 + (kMode == kQmm2 ? g8 : 2 * g8);
  const int n_hi = nt * 16 + (kMode == kQmm2 ? g8 + 8 : 2 * g8 + 1);
  // two accumulators: steps go in pairs, one chain each, so that a pair's
  // loads and products overlap; a group's partial is their sum
  float accf[2][4] = {};
  int acci[2][4] = {};
  bf16* priv = reinterpret_cast<bf16*>(base + lay.priv + warp * kPriv);

  // n (1 or 2) 32-row steps of the tile: K rows kr.. of the box, k.. of K
  auto steps = [&](auto count, const uint8_t* box, int kr, int k) {
    constexpr int n = decltype(count)::value;
    const uint8_t* src[n];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int row = kr + 32 * j + lane;
      src[j] = box + row * kW + 16 * (nt ^ swz(row));
    }
    if constexpr (kMode == kQmm4) {
      uint32_t r[n][4], b[4];
#pragma unroll
      for (int j = 0; j < n; ++j) ldsm_x4_trans(r[j], src[j]);  // K rows 8i.. of the tile, b16 units transposed
      // xq's B fragments: 16 bytes a k16 half (the x2 form reads lanes 0-15's rows)
      ldsm_x4(b, reinterpret_cast<const bf16*>(xq + (lane & 7) * xqld + k + 16 * ((lane >> 3) & (2 * n - 1))));
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const uint32_t a[4] = {__byte_perm(r[j][0], r[j][1], 0x6420), __byte_perm(r[j][0], r[j][1], 0x7531),
                               __byte_perm(r[j][2], r[j][3], 0x6420), __byte_perm(r[j][2], r[j][3], 0x7531)};
        mma_s8(acci[j], a, b[2 * j], b[2 * j + 1]);
      }
    } else {
      uint32_t b[n][4];  // x's B fragments of each step's two k16 halves
#pragma unroll
      for (int j = 0; j < n; ++j)
        ldsm_x4(b[j], reinterpret_cast<const bf16*>(xs + x_off(lane & 7, k + 32 * j + 8 * (lane >> 3))));
      if constexpr (kMode == kQmm3) {
        uint32_t r[n][4];
#pragma unroll
        for (int j = 0; j < n; ++j) ldsm_x4_trans(r[j], src[j]);
#pragma unroll
        for (int j = 0; j < n; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // byte 0 / 2 of a register: column 2g, K rows 2t / 2t + 1; bytes 1 / 3: column 2g + 1
            const uint32_t a[4] = {s8pair_bf16(r[j][2 * h]), s8pair_bf16(r[j][2 * h] >> 8),
                                   s8pair_bf16(r[j][2 * h + 1]), s8pair_bf16(r[j][2 * h + 1] >> 8)};
            mma16816(accf[j], a, b[j][2 * h], b[j][2 * h + 1]);
          }
      } else {
        // widen this lane's K row of each step (16 bytes) into the warp's bf16 copies
        uint4 v[n];
#pragma unroll
        for (int j = 0; j < n; ++j) v[j] = *reinterpret_cast<const uint4*>(src[j]);
        uint32_t o[n][8];
#pragma unroll
        for (int j = 0; j < n; ++j) {
          const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            o[j][2 * q] = s8pair_bf16(__byte_perm(w[q], 0, 0x3120));
            o[j][2 * q + 1] = s8pair_bf16(__byte_perm(w[q], 0, 0x1302));
          }
        }
        __syncwarp();  // the copies' last readers are done
#pragma unroll
        for (int j = 0; j < n; ++j) {
          uint4* dst = reinterpret_cast<uint4*>(priv + (j * 32 + lane) * kPrivLd);
          dst[0] = make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
          dst[1] = make_uint4(o[j][4], o[j][5], o[j][6], o[j][7]);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < n; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = lane >> 3, r = lane & 7;
            uint32_t a[4];
            ldsm_x4_trans(a, priv + (j * 32 + h * 16 + r + 8 * (i >> 1)) * kPrivLd + 8 * (i & 1));
            mma16816(accf[j], a, b[j][2 * h], b[j][2 * h + 1]);
          }
      }
    }
  };

  // the group's partial times its scale, into its product slot (the mma's C
  // layout: C rows are columns, C columns rows of x)
  float s_lo = 0.f, s_hi = 0.f;
  auto load_scales = [&](int g) {
    if (g < G) {
      s_lo = __ldg(scales + (size_t)g * N + n0 + n_lo);
      s_hi = __ldg(scales + (size_t)g * N + n0 + n_hi);
    }
  };
  auto finish = [&](int g) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = i < 2 ? s_lo : s_hi;
      if constexpr (kMode == kQmm4) {
        p[i] = __fmul_rn(__int2float_rn(acci[0][i] + acci[1][i]), __fmul_rn(sxs[2 * t4 + (i & 1)], s));
        acci[0][i] = acci[1][i] = 0;
      } else {
        p[i] = __fmul_rn(__fadd_rn(accf[0][i], accf[1][i]), s);
        accf[0][i] = accf[1][i] = 0.f;
      }
    }
    prods[(g * kTiles + nt) * 32 + lane] = make_float4(p[0], p[1], p[2], p[3]);
  };

  int g = wq, gk0 = g * gs;
  load_scales(g);
  for (int b = 0; b < boxes; ++b) {
    const int s = b % stages, bk0 = b * kRows, bk1 = min(K, bk0 + kRows);
    mbar_wait(&full[s], (b / stages) & 1);  // every warp waits every box: see the release below
    const uint8_t* box = ring + s * kBoxBytes;
    while (g < G && gk0 < bk1) {
      const int k_hi = min(gk0 + gs, bk1);
      // planted: one group dropped from one strip's walk
      if (!(plant == 1 && blockIdx.x == 0 && blockIdx.y == 0 && g == 1)) {
        int k = max(gk0, bk0);
        for (; k + 32 < k_hi; k += 64) steps(std::integral_constant<int, 2>(), box, k - bk0, k);
        if (k < k_hi) steps(std::integral_constant<int, 1>(), box, k - bk0, k);
      }
      if (gk0 + gs > bk1) break;  // the group goes on in the next box
      finish(g);
      g += kShare, gk0 = g * gs;
      load_scales(g);
    }
    if (b + stages < boxes) {
      // the last warp done with the box refills its stage: its reads are
      // ordered before the counter, and the counter before the copy
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(&cnt[s], 1) == kWarps - 1) {
          cnt[s] = 0;
          __threadfence_block();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(b + stages);
        }
      }
    }
  }
  __syncthreads();

  // the strip's outputs, one warp a tile: acc = acc + product_g in group order
  if (wq == 0) {
    float tot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < G; ++j) {
      const float4 p = prods[((plant == 2 ? G - 1 - j : j) * kTiles + nt) * 32 + lane];  // planted: reversed
      tot[0] = __fadd_rn(tot[0], p.x);
      tot[1] = __fadd_rn(tot[1], p.y);
      tot[2] = __fadd_rn(tot[2], p.z);
      tot[3] = __fadd_rn(tot[3], p.w);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 2 * t4 + (i & 1);
      if (m < rows) out[(size_t)(m0 + m) * N + n0 + (i < 2 ? n_lo : n_hi)] = tot[i];
    }
  }
}

// qw (K, N) int8 read in boxes of 32 columns x 256 rows, 32-byte swizzle,
// zeros past K
inline int weight_map(CUtensorMap* map, const void* qw, int K, int N) {
  const ds_hopper::EncodeTiled fn = ds_hopper::encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kW, (cuuint32_t)kRows};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw), dims, strides, box,
                        estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// x (M, K) bf16 as slabs of 64 columns (128 bytes) by 8 rows, `slabs` of
// them a copy: the view (64 columns, M rows, K / 64 slabs), 128-byte
// swizzle, zeros past M and past the last slab
inline int x_map(CUtensorMap* map, const void* x, int M, int K, int slabs) {
  const ds_hopper::EncodeTiled fn = ds_hopper::encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {64, (cuuint64_t)M, (cuuint64_t)(K / 64)};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, 128};
  const cuuint32_t box[3] = {64, kRowsM, (cuuint32_t)slabs};
  const cuuint32_t estrides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, estrides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
int launch(const void* x, const void* qw, const void* scales, void* out, int M, int K, int N, int G,
           int stages, int smem, int plant, cudaStream_t s) {
  static bool attr = false;
  if (const int rc = ds_hopper::set_smem(qmm_kernel<kMode>, kMaxSmem, attr)) return rc;
  // the host's figure must hold the kernel's layout
  if (smem < Layout(kMode, K, G, stages).bytes || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, tx;
  if (const int rc = weight_map(&tw, qw, K, N)) return rc;
  if (const int rc = x_map(&tx, x, M, K, x_slabs(K))) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kW, (M + kRowsM - 1) / kRowsM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr_cluster[1];
  attr_cluster[0].id = cudaLaunchAttributeClusterDimension;
  attr_cluster[0].val.clusterDim.x = kCluster;
  attr_cluster[0].val.clusterDim.y = 1;
  attr_cluster[0].val.clusterDim.z = 1;
  cfg.attrs = attr_cluster;
  cfg.numAttrs = 1;
  const int rc = static_cast<int>(cudaLaunchKernelEx(&cfg, qmm_kernel<kMode>, tw, tx,
                                                     static_cast<const float*>(scales), static_cast<float*>(out),
                                                     M, K, N, G, stages, plant));
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity and
// 16-byte alignment, that K / G is a multiple of 32, K of 64 and N of 128,
// and chose `stages` and `smem`, the shared memory a CTA takes
// (ops/qmm_microbench.py::_grid). mode 0 / 1 / 2 is qmm2 / qmm3 / qmm4.
// plant: 0, or a fault the card's gates must catch (1: group 1 dropped from
// the first strip's walk; 2: the groups summed in reverse order). One launch
// on `stream`; returns the launch's error code.
DS_EXPORT int qmm_microbench_launch(int mode, const void* x, const void* qw, const void* scales, void* out,
                                    int M, int K, int N, int G, int stages, int smem, int plant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kQmm2: return launch<kQmm2>(x, qw, scales, out, M, K, N, G, stages, smem, plant, s);
    case kQmm3: return launch<kQmm3>(x, qw, scales, out, M, K, N, G, stages, smem, plant, s);
    case kQmm4: return launch<kQmm4>(x, qw, scales, out, M, K, N, G, stages, smem, plant, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
