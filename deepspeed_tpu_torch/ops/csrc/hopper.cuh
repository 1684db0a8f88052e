// Hopper's asynchronous pieces, shared by the kernels that use them
// (quant_matmul.cu's wide path, flash_attention_fwd.cu and _bwd.cu, the
// block-sparse kernels): wgmma (fence, commit, wait;
// m64nNk16 with both operands in shared memory, N = 64 or 128, and with A
// from registers and B K-major or MN-major; the products of the flash
// backward, mma_nt and mma_rn, and its accumulator helpers), the
// descriptors of the 128-byte swizzled layouts that TMA writes, setmaxnreg,
// the mbarriers of a producer/consumer ring, and TMA loads of 2D and 3D
// tensor maps with the host-side encoder.
//
// Shared-memory layouts (128-byte swizzle; a tile starts on a 1024-byte
// boundary). A TMA box of 64 bf16 columns x R rows lands as R rows of 128
// bytes, row r's 16-byte chunk j at chunk j ^ (r % 8); 8 rows make a
// 1024-byte atom.
//   K-major operand (the contraction along the 128-byte rows): a k16 step
// is 32 bytes along the row, 8-row atoms 1024 bytes apart (sw128_desc).
//   MN-major operand (the contraction down the rows, B = a tile of V whose
// rows are keys): a k16 step is 16 rows (2048 bytes), atoms along K 1024
// bytes apart, the next 64 columns `lbo` bytes away (sw128_mn_desc), read
// with the wgmma's B transposed (imm-trans-b 1).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; the encoder is looked up at run time)

#include "mma_tile.cuh"

namespace ds_hopper {

using ds_mma::smem_u32;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers after a wait: the compiler must neither read an
// accumulator earlier nor reuse a register the wgmma still reads
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// descriptor of a K-major operand in the 128-byte swizzled layout: rows of
// 64 bf16 (128 bytes), 8-row atoms of 1024 bytes (the stride between them)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// descriptor of an MN-major operand in the same layout: 8 K rows of 64 MN
// elements form an atom, atoms along K 1024 bytes apart (the stride byte
// offset), the next 64 MN elements lbo bytes away (the leading byte offset)
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 fp32, the warpgroup's accumulator) (+)= a (64 x 16, K-major
// in shared memory) * b (16 x 128, K-major in shared memory); scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6,"
      " %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// the same with n = 64: d (64 x 64 fp32)
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 fp32) (+)= a (64 x 16 bf16 in registers, mma.m16n8k16's A
// layout per warp) * b (16 x 128 in shared memory: K-major, or MN-major
// with TransB = 1); scale_d 0 overwrites d
template <int TransB>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6,"
      " %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int scale_d) {
  wgmma_rs_m64n128<0>(d, a, b, scale_d);
}

// the same with n = 64: d (64 x 64 fp32)
template <int TransB>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24,"
      " %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// d (64 x N fp32) (+)= a (64 x 16 bf16 in registers) * b (16 x N, MN-major
// in shared memory), N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs_mn: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_rs_m64n128<1>(d, a, b, scale_d);
  else
    wgmma_rs_m64n64<1>(d, a, b, scale_d);
}

// d (64 x N) = A (64 rows x D) B^T (B: N rows x D), both K-major in
// 64-column blocks of the 128-byte swizzle, a_block and b_block bytes
// apart; N = 64 or 128
template <int D, int N = 64>
__device__ __forceinline__ void mma_nt(float (&d)[N / 2], const uint8_t* a, int a_block, const uint8_t* b,
                                       int b_block) {
  static_assert(N == 64 || N == 128, "mma_nt: N is 64 or 128");
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {  // a k16 step is 32 bytes along the swizzled row
    const int c = t / 4, k32 = (t % 4) * 32;
    if constexpr (N == 128)
      wgmma_ss_m64n128(d, sw128_desc(a + c * a_block + k32), sw128_desc(b + c * b_block + k32), t > 0);
    else
      wgmma_ss_m64n64(d, sw128_desc(a + c * a_block + k32), sw128_desc(b + c * b_block + k32), t > 0);
  }
}

// d (64 x D) += A (64 x 16 KC, bf16 fragments) B (16 KC rows x D: the rows
// are the contraction, read MN-major; 64-column blocks b_block bytes apart)
template <int D, int KC>
__device__ __forceinline__ void mma_rn(float (&d)[D / 2], const uint32_t (&a)[KC][4], const uint8_t* b,
                                       int b_block) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)  // a k16 step is 16 rows, 2048 bytes
    wgmma_rs_mn<D>(d, a[kc], sw128_mn_desc(b + kc * 16 * 128, b_block), 1);
}

// a 64 x N accumulator (or mma.sync's 16 x N, the same per-lane layout) as
// A fragments, 16 columns each: n8 tiles 2kc and 2kc + 1 (the bf16
// rounding point)
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    f[kc][0] = ds_mma::pack_bf16(x[8 * kc], x[8 * kc + 1]);
    f[kc][1] = ds_mma::pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    f[kc][2] = ds_mma::pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    f[kc][3] = ds_mma::pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// accumulator 4i..4i+3 is n8 tile i: (row_lo, 8i + col2 + {0, 1}), (row_lo +
// 8, ...); rows below `rows` are written as bf16 rows of a (rows, D) matrix
template <int D>
__device__ __forceinline__ void store_acc(ds_mma::bf16* dst, const float (&x)[D / 2], int row_lo, int rows,
                                          int col2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * i + col2) =
            __floats2bfloat162_rn(x[4 * i + 2 * h], x[4 * i + 2 * h + 1]);
    }
  }
}

// moves registers between the warpgroups of a CTA: every warp of the
// warpgroup executes it; what one warpgroup gives back the others may take
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// mbarriers and TMA (a producer/consumer ring)
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
// waits for the phase of `parity` to complete; a wait of more than 2^32
// cycles (seconds) traps, so a broken ring ends the launch with an error
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 32))
      __trap();
  }
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
// the same for a 3D tensor map (coordinates: inner, middle, outer)
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
      "%4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, looked up at run time through cudaGetDriverEntryPoint
// (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous tensor of `rank` dimensions (dims innermost first) read in
// boxes of 128 bytes x box_outer[0] x box_outer[1] ..., 128-byte swizzled,
// zeros past every edge
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem_bytes,
                    int rank, const uint64_t* dims, const uint32_t* box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[5], strides[4];
  cuuint32_t box[5], estrides[5];
  uint64_t stride = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    box[i] = i == 0 ? static_cast<cuuint32_t>(128 / elem_bytes) : box_outer[i - 1];
    estrides[i] = 1;
    stride *= dims[i];
    if (i + 1 < rank) strides[i] = stride;
  }
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), d, strides, box, estrides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
// a contiguous (heads, rows, D) bf16 tensor read in boxes of 64 columns x
// box_rows rows of one head (two boxes a row at D = 128)
inline int bf16_map(CUtensorMap* map, const void* base, int D, int rows, int heads, uint32_t box_rows) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, (uint64_t)heads};
  const uint32_t box[2] = {box_rows, 1};
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, dims, box);
}
// as many CTAs of `kern` as fit on the current card at once (a persistent
// grid), cached per call site and device
template <typename Kern>
int resident_ctas(Kern* kern, int threads, int smem, int& dev_cached, int& resident) {
  int dev = 0;
  if (const int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (dev != dev_cached) {
    int sms = 0, per_sm = 0;
    if (const int rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
      return rc;
    if (const int rc = static_cast<int>(
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)))
      return rc;
    resident = max(1, sms * per_sm);
    dev_cached = dev;
  }
  return 0;
}
// the dynamic shared memory a kernel may take, set once per instantiation
template <typename Kern>
int set_smem(Kern* kern, int bytes, bool& done) {
  if (done) return 0;
  const int rc = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  done = rc == 0;
  return rc;
}

}  // namespace ds_hopper
