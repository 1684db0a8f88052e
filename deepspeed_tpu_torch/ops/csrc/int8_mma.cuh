// Warp- and warpgroup-level pieces of an int8-weight tensor-core product
// (quant_matmul.cu; fit for kernels A and C of the fused decode layer too):
// cp.async with zero fill, ldmatrix, the exact int8 -> bf16 widening of an
// ldmatrix.trans tile into mma.m16n8k16 A fragments (column 2g of a warp's
// 16 is A row g, column 2g + 1 row g + 8), wgmma m64n128k16 with A from
// registers and B K-major in the 128-byte swizzled layout, and the
// mbarriers and TMA loads of a producer/consumer ring.
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

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators after a wait: the compiler must not read them earlier
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a K-major operand in the 128-byte swizzled layout: rows of
// 64 bf16 (128 bytes), 8-row atoms of 1024 bytes (the stride between them)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 128 fp32, the warpgroup's accumulator) (+)= a (64 x 16 bf16 in
// registers, mma.m16n8k16's A layout per warp) * b (16 x 128, K-major in
// shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "
      "%66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}


// mbarriers and TMA (the wide path's producer/consumer ring)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a box of a 2D tensor map (coordinates: inner, outer) into shared memory;
// completes on bar's transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace ds_int8
