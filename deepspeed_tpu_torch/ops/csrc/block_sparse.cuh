// Pieces shared by the block-sparse forward, dq and dk/dv kernels
// (block_sparse_attention_fwd.cu, block_sparse_attention_bwd.cu): the CTA
// of item groups, mma.sync on the tiles TMA writes in the 128-byte swizzle,
// a cp.async of fp32 values that lands on a ring slot's mbarrier, and the
// arrival count of a split row's pieces.
//
// A work item (ops/sparse_attention/block_sparse_attention.py::WorkPlan) is
// an int4 (h * rows + row, first table position, length, split id or -1); a
// split row is an int2 (index of its first partial, its pieces). The plan
// is built on the host from the layout alone.
#pragma once

#include "hopper.cuh"

namespace ds_sparse {

using ds_mma::bf16;
using ds_mma::ldsm_x4;
using ds_mma::ldsm_x4_trans;
using ds_mma::smem_u32;
using namespace ds_hopper;

constexpr int kStages = 3;  // ring slots an item
constexpr int kBox = 64;    // bf16 columns a TMA box: one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A CTA is kItems groups of kWarps warps, one work item a group, every
// warp 16 rows of the item's block: blocks 16 and 32 take four and two
// items on mma.sync, blocks 64 and 128 one item on one or two warpgroups
// (wgmma). Every CTA has at least four warps.
template <int BLK>
struct Group {
  static constexpr int kWarps = BLK / 16;
  static constexpr int kItems = kWarps >= 4 ? 1 : 4 / kWarps;
  static constexpr int kThreads = kItems * kWarps * 32;
  static constexpr bool kWgmma = BLK >= 64;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (r, c) of a tile of R rows as TMA writes it with
// the 128-byte swizzle: 64-column blocks R * 128 bytes apart, row r's
// 16-byte chunk j at chunk j ^ (r % 8) (the tile starts on 1024 bytes)
template <int R>
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// c (16x8 fp32, the four accumulators at c) += a (16x16 bf16) b (16x8 bf16)
__device__ __forceinline__ void mma16816p(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of rows r0 .. r0 + 15 (K columns) of a swizzled tile of R rows
template <int K, int R>
__device__ __forceinline__ void ld_a_frags(uint32_t (&af)[K / 16][4], const uint8_t* t, int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
    ldsm_x4(af[kc], reinterpret_cast<const bf16*>(t + sw_off<R>(r0 + (lane & 15), kc * 16 + (lane >> 4) * 8)));
}

// acc (16 x N, accumulator 4i..4i+3 the n8 tile i) += A (16 x K, fragments)
// Bt^T, Bt the first N rows (K columns) of a swizzled tile of R rows
template <int K, int N, int R>
__device__ __forceinline__ void mma_ab_t(float (&acc)[N / 2], const uint32_t (&af)[K / 16][4], const uint8_t* bt,
                                         int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4(bf, reinterpret_cast<const bf16*>(
                      bt + sw_off<R>(n0 + (lane & 7) + ((lane >> 4) << 3), kc * 16 + ((lane >> 3) & 1) * 8)));
      mma16816p(acc + 4 * (n0 / 8), af[kc], bf[0], bf[1]);
      mma16816p(acc + 4 * (n0 / 8 + 1), af[kc], bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += A (16 x K, fragments) B, B the first K rows (N columns;
// the rows are the contraction) of a swizzled tile of R rows
template <int K, int N, int R>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 2], const uint32_t (&af)[K / 16][4], const uint8_t* b,
                                       int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, reinterpret_cast<const bf16*>(b + sw_off<R>(kc * 16 + (lane & 15), n0 + (lane >> 4) * 8)));
      mma16816p(acc + 4 * (n0 / 8), af[kc], bf[0], bf[1]);
      mma16816p(acc + 4 * (n0 / 8 + 1), af[kc], bf[2], bf[3]);
    }
  }
}

// d (64 x N) = A (64 x K, bf16 fragments in registers: the warp's 16
// rows, mma.m16n8k16's A layout) B^T, B N rows (K columns) K-major in
// 64-column blocks of the 128-byte swizzle, b_block bytes apart; N = 64 or
// 128
template <int K, int N>
__device__ __forceinline__ void mma_rt(float (&d)[N / 2], const uint32_t (&a)[K / 16][4], const uint8_t* b,
                                       int b_block) {
#pragma unroll
  for (int t = 0; t < K / 16; ++t) {  // a k16 step is 32 bytes along the swizzled row
    const uint64_t desc = sw128_desc(b + (t / 4) * b_block + (t % 4) * 32);
    if constexpr (N == 128)
      wgmma_rs_m64n128<0>(d, a[t], desc, t > 0);
    else
      wgmma_rs_m64n64<0>(d, a[t], desc, t > 0);
  }
}

// the barrier of item group gi: its warp, its two warps (a named barrier
// a group) or the whole CTA
template <int BLK>
__device__ __forceinline__ void group_sync(int gi) {
  using G = Group<BLK>;
  if constexpr (G::kItems == 1)
    __syncthreads();
  else if constexpr (G::kWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gi), "n"(G::kWarps * 32) : "memory");
}

// *dst = *src (one fp32) if valid, else 0, by cp.async
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// an arrival on bar once this thread's earlier cp.async have landed (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// After every thread of group gi wrote its piece's partials: true in the
// group of the split row's last piece to arrive (an integer count of
// arrivals, no float atomics), which then merges; that group leaves the
// count at 0. The partials the merge reads were made visible by each
// writer's fence before its group arrived.
template <int BLK>
__device__ __forceinline__ bool last_to_arrive(int* count, int pieces, int* flag, int gi, bool leader) {
  __threadfence();
  group_sync<BLK>(gi);
  if (leader) {
    const bool last = atomicAdd(count, 1) == pieces - 1;
    if (last) *count = 0;
    *flag = last;
  }
  group_sync<BLK>(gi);
  const bool last = *reinterpret_cast<volatile int*>(flag) != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace ds_sparse
