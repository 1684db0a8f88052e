// Warp-level tensor-core pieces for the decode kernel (also through
// int8_mma.cuh), quant_matmul's mainloops and the microbench: bf16 operands
// staged in shared memory (row stride D + 8 elements, so the eight 16-byte
// rows an ldmatrix phase reads fall in distinct banks), ldmatrix, mma.sync
// m16n8k16 with fp32 accumulators and bf16 packing. hopper.cuh and
// block_sparse.cuh (the flash and block-sparse kernels) take smem_u32,
// ldmatrix and pack_bf16 from here.
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

}  // namespace ds_mma
