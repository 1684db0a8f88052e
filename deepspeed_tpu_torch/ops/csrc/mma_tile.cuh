// Warp-level tensor-core tiles for the block-sparse attention kernels, the
// decode kernel (through int8_mma.cuh) and the microbench: bf16
// operands staged in shared memory (row stride D + 8 elements, so the eight
// 16-byte rows an ldmatrix phase reads fall in distinct banks), mma.sync
// m16n8k16 with fp32 accumulators, and the conversion of an accumulator into
// the A operand of the next product (FlashAttention-2's register reuse).
// hopper.cuh (the flash kernels, quant_matmul's wide path) takes smem_u32
// and pack_bf16 from here.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * g + t:
//   A 16x16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..), a3 (g+8, 8+2t..)
//   B 16x8:  b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g)
//   C 16x8:  c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
#pragma once

#include "common.cuh"

namespace ds_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16) b (16x8 bf16)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc (16 x N) += A (16 x K) * Bt^T, both in shared memory with K contiguous:
// A rows at a (stride lda), Bt rows (one per output column) at bt (stride ldb)
template <int K, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a, int lda,
                                        const bf16* bt, int ldb, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4(bf, bt + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ldb + k0 + ((lane >> 3) & 1) * 8);
      mma16816(acc[n0 / 8], af, bf[0], bf[1]);
      mma16816(acc[n0 / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += A (16 x K, bf16 fragments in registers) * B, with B (K x N)
// in shared memory row-major (N contiguous, stride ldb)
template <int K, int N>
__device__ __forceinline__ void mma_rb(float (&acc)[N / 8][4], const uint32_t (&af)[K / 16][4],
                                       const bf16* b, int ldb, int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kc * 16 + (lane & 15)) * ldb + n0 + (lane >> 4) * 8);
      mma16816(acc[n0 / 8], af[kc], bf[0], bf[1]);
      mma16816(acc[n0 / 8 + 1], af[kc], bf[2], bf[3]);
    }
  }
}

// accumulator layout (16 x K fp32, K/8 tiles) -> A fragments (K/16 chunks);
// the bf16 rounding point of the TPU kernels
template <int K>
__device__ __forceinline__ void to_a_frags(uint32_t (&af)[K / 16][4], const float (&c)[K / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    af[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    af[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    af[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    af[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix into shared memory with
// row stride D + 8 (conflict-free ldmatrix); rows past `rows` are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int rows) {
  constexpr int kLd = D + 8, kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = val;
  }
}

// write a warp's 16 x D accumulator (rows row_lo and row_lo + 8 of this
// lane) as bf16 rows of a (rows, D) matrix
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[D / 8][4], int row_lo,
                                           int rows, int lane) {
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (row_lo < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row_lo * D + nt * 8 + col) =
          __floats2bfloat162_rn(c[nt][0], c[nt][1]);
    if (row_lo + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row_lo + 8) * D + nt * 8 + col) =
          __floats2bfloat162_rn(c[nt][2], c[nt][3]);
  }
}

}  // namespace ds_mma
