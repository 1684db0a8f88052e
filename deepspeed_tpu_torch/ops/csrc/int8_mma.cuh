// Warp-level pieces of an int8-weight tensor-core product (quant_matmul.cu;
// fit for kernels A and C of the fused decode layer too): cp.async with
// zero fill, ldmatrix, and the exact int8 -> bf16 widening of an
// ldmatrix.trans tile into mma.m16n8k16 A fragments (column 2g of a warp's
// 16 is A row g, column 2g + 1 row g + 8), which also feed wgmma's A from
// registers. The wgmma, mbarrier and TMA pieces are in hopper.cuh.
#pragma once

#include "mma_tile.cuh"

namespace ds_int8 {

using ds_mma::smem_u32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// bytes 0 and 2 of v (signed int8) -> bf16x2 (byte 0 in the low half).
// 0x43XX is the bf16 128 + (XX & 127) when bit 7 of XX is clear; so a byte
// b >= 0 is (128 + b) - 128 and a byte b < 0 (bit 7 set, low bits b + 128)
// is (128 + b + 128) - 256, and 256 is 0x4380: the subtrahend takes the
// byte's bit 7 as its exponent's low bit. Both operands and the difference
// are integers of at most 9 significant bits, so the subtraction is exact.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t v) {
  const uint32_t hi = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t sub = (v & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                             *reinterpret_cast<const __nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&d);
}

// one ldmatrix.trans register of int8 bytes (k 2t | 2t+1) x (n 2g | 2g+1)
// -> the bf16 pairs of column 2g (bytes 0, 2) and of column 2g + 1 (1, 3)
__device__ __forceinline__ void widen(uint32_t r, uint32_t& even, uint32_t& odd) {
  even = s8x2_to_bf16x2(r);
  odd = s8x2_to_bf16x2(r >> 8);
}

// 32 K rows x 16 columns of an int8 tile in shared memory (row stride LD
// bytes, rows in distinct banks) -> a warp's A fragments of two k16 steps
template <int LD>
__device__ __forceinline__ void widen_rows32(uint32_t (&a0)[4], uint32_t (&a1)[4],
                                             const uint8_t* tile, int lane) {
  uint32_t r[4];  // K rows 8i..8i+7, b16 units transposed
  ldsm_x4_trans(r, tile + lane * LD);
  widen(r[0], a0[0], a0[1]);
  widen(r[1], a0[2], a0[3]);
  widen(r[2], a1[0], a1[1]);
  widen(r[3], a1[2], a1[3]);
}

}  // namespace ds_int8
