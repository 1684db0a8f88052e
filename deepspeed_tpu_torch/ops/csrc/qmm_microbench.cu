// The three w8a16 / w8a8 tilings of the decode-shape microbench on Hopper:
// out (M, N) fp32 = sum over groups g of part_g * scale, where part_g is
// the product of x's and W's rows of quantization group g.
//
// Replaces the TPU kernels of benchmarks/qmm_microbench.py:
//   qmm2_kernel <- _qmm2_kernel: the int8 tile widened to bf16 before the dot;
//   qmm3_kernel <- _qmm3_kernel: the same function, the s8 operand handed to
//                  the dot (no widened copy of the tile);
//   qmm4_kernel <- _qmm4_kernel: w8a8, an int8 x int8 dot in int32 per group,
//                  scaled by the row's activation scale times the group's.
//
// Layout (the JAX one): x (M, K) bf16 (qmm4: xq (M, K) int8 and sx (M,)
// fp32, quantized by the wrapper as the JAX code does outside pallas_call);
// qw (K, N) int8; scales (G, N) fp32, group size gs = K / G; out (M, N) fp32.
//
// What bounds it on the H100: at the bench's decode shape (M 8, K 1280,
// N 5120) the 6.5 MB of int8 weight bytes over 3.35 TB/s, about 2 us; the
// 2*M*K*N multiply-adds are 0.1 us even at the bf16 tensor-core rate. So a
// kernel's speed is how many weight bytes it keeps in flight; the three
// tilings differ in what happens to a byte once it is in shared memory,
// which is the question the bench asks:
//   qmm2: the int8 tile goes to shared memory (cp.async), every thread widens
//         16 bytes of it into a bf16 copy there, and warps read bf16 A
//         fragments with ldmatrix.trans for mma.sync m16n8k16 (fp32 sums);
//   qmm3: no bf16 copy: ldmatrix.trans reads the int8 tile's bytes in b16
//         units straight into registers, where they are widened (shifts and
//         cvt) right before the same bf16 mma. Hopper has no mixed bf16 x s8
//         MMA, so this is its counterpart of handing the s8 operand to the dot;
//   qmm4: the int8 bytes from ldmatrix.trans are byte-permuted into s8 A
//         fragments for mma.sync m16n8k32 .s32.s8.s8.s32 (int32 sums, exact).
//
// Design. M = 8 fills half of an m16 tile, so each kernel computes the
// transposed product out^T = W^T x^T: N takes the m16 side and M = 8 is
// exactly n8 (grid y walks M in tiles of 8). A block is one grid step of the
// JAX kernel: block_n columns (the JAX block_n, a launch parameter, so the
// three qmm2 variants are three configurations of one kernel) by ONE group
// of K rows (grid z = G). The JAX grid's sequential K axis carries the sum
// from step to step in VMEM; blocks here run in parallel, so each writes its
// group's unscaled partial (fp32, or int32 for qmm4) to a workspace, and a
// second launch (one block per 128-column strip) applies the scales and sums
// the groups in group order, acc = acc + part_g * s_g (qmm4: acc +
// float(part_g) * (sx[m] * s[g, n])) with __fmul_rn / __fadd_rn, as the
// plain version does (the JAX kernel's CPU run fuses the multiply-add): a
// group's partial is the same whichever block made it, so the result is the
// same on every run, and qmm4's exact int32 partials make it bitwise its
// plain version. (Summing in the first launch, by the last block of a strip
// to arrive, took a fence and an atomic a strip, and the block's weight
// loads waited on them: qmm2 at block_n 512 took 0.0308 ms so on the H100,
// 0.0209 with the second launch; chip_smoke.py's kernel rows.)
// Inside a block the 8 warps
// each own 16 of the 128 columns of a staged chunk (32 K rows x 128 columns,
// one 16-byte cp.async per thread), and a ring of kStages chunks keeps up to
// 5 chunks (20 KB) of weight bytes in flight per block.
//
// ldmatrix.trans on int8 (qmm3, qmm4): each 8 x 8 b16 matrix is 8 K rows of
// 16 bytes (16 columns); a lane receives K rows 2t, 2t+1 of the column PAIR
// (2g, 2g+1): bytes (k 2t, n 2g), (k 2t, n 2g+1), (k 2t+1, n 2g),
// (k 2t+1, n 2g+1). Bytes 0 and 2 are one column and two K rows, which is a
// bf16 A fragment register after widening; so the mma's row g is column 2g
// and its row g + 8 is column 2g + 1. For m16n8k32 a register holds 4 K
// values of one row: the K order inside the 32-row step is permuted
// (kappa 4t..4t+3 <-> k 2t, 2t+1, 8+2t, 9+2t), and the B fragments of xq
// are gathered in the same order, which leaves the integer dot unchanged.

#include "mma_tile.cuh"

namespace {

using ds_mma::bf16;
using ds_mma::mma16816;
using ds_mma::pack_bf16;
using ds_mma::smem_u32;

constexpr int kThreads = 256;          // 8 warps
constexpr int kChunkN = 128;           // columns of a staged chunk: 16 per warp
constexpr int kChunkK = 32;            // K rows of a staged chunk
constexpr int kStageLd = kChunkN + 16; // int8 row stride: 8 ldmatrix rows in distinct banks
constexpr int kTileLd = kChunkN + 8;   // bf16 row stride of qmm2's widened tile
constexpr int kStages = 6;             // ring of staged chunks
constexpr int kRowsM = 8;              // rows of x per block (the mma's n8)
constexpr int kMaxGs = 512;            // largest group the x stage holds
constexpr int kXLd = kMaxGs + 8;       // bf16 x stage row stride (conflict-free B loads)
constexpr int kXqLd = kMaxGs + 16;

enum Mode { kQmm2 = 0, kQmm3 = 1, kQmm4 = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
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

// c (16x8 s32) += a (16x32 s8) b (32x8 s8)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 4 signed bytes of r as floats (exact: |v| <= 128)
__device__ __forceinline__ void s8x4_to_f32(uint32_t r, float (&f)[4]) {
  const int v = static_cast<int>(r);
  f[0] = static_cast<float>((v << 24) >> 24);
  f[1] = static_cast<float>((v << 16) >> 24);
  f[2] = static_cast<float>((v << 8) >> 24);
  f[3] = static_cast<float>(v >> 24);
}

// one ldmatrix.trans register of int8 bytes (k 2t | 2t+1) x (n 2g | 2g+1)
// -> the bf16 pairs of column 2g (bytes 0, 2) and column 2g + 1 (bytes 1, 3)
__device__ __forceinline__ void widen_pairs(uint32_t r, uint32_t& even, uint32_t& odd) {
  float f[4];
  s8x4_to_f32(r, f);
  even = pack_bf16(f[0], f[2]);
  odd = pack_bf16(f[1], f[3]);
}

// out[m, n] for the 128 columns of a strip and its rows: acc = acc +
// part_g * scale over g in order, each product and sum rounded once. A
// thread owns one column and half of the rows; loads of up to 8 groups are
// issued before their sums so that they overlap.
template <int kMode>
__device__ __forceinline__ void reduce_strip(const void* ws, const float* __restrict__ scales,
                                             const float* __restrict__ sx, float* __restrict__ out,
                                             int M, int N, int m0, int rows, int n_strip,
                                             int groups) {
  constexpr int kHalf = kRowsM / 2;
  const int n = n_strip + threadIdx.x % kChunkN;
  const int r0 = threadIdx.x / kChunkN * kHalf;
  float acc[kHalf] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = 0; g0 < groups; g0 += 8) {
    float part[8][kHalf], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = g0 + j;
      s[j] = g < groups ? __ldg(scales + (size_t)g * N + n) : 0.f;
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const size_t at = ((size_t)g * M + m0 + r0 + r) * N + n;
        const bool live = g < groups && r0 + r < rows;
        if constexpr (kMode == kQmm4) {
          part[j][r] = live ? __int2float_rn(__ldcg(static_cast<const int*>(ws) + at)) : 0.f;
        } else {
          part[j][r] = live ? __ldcg(static_cast<const float*>(ws) + at) : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (g0 + j < groups) {
#pragma unroll
        for (int r = 0; r < kHalf; ++r) {
          const float scale =
              kMode == kQmm4 && r0 + r < rows ? __fmul_rn(__ldg(sx + m0 + r0 + r), s[j]) : s[j];
          acc[r] = __fadd_rn(acc[r], __fmul_rn(part[j][r], scale));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kHalf; ++r)
    if (r0 + r < rows) out[(size_t)(m0 + r0 + r) * N + n] = acc[r];
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
qmm_group_kernel(const void* __restrict__ xv, const int8_t* __restrict__ qw, void* __restrict__ ws,
                 int M, int K, int N, int gs, int block_n) {
  __shared__ __align__(16) int8_t stage[kStages][kChunkK * kStageLd];
  __shared__ __align__(16) bf16 tile[kMode == kQmm2 ? kChunkK * kTileLd : 8];
  __shared__ __align__(16) bf16 xs[kMode == kQmm4 ? 8 : kRowsM * kXLd];
  __shared__ __align__(16) int8_t xqs[kMode == kQmm4 ? kRowsM * kXqLd : 16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_tile = blockIdx.x * block_n;
  const int m0 = blockIdx.y * kRowsM;
  const int rows = min(kRowsM, M - m0);
  const int grp = blockIdx.z;
  const int k_grp = grp * gs;

  // the group's slice of x (rows past M are zeros): the B operand of every chunk
  if constexpr (kMode == kQmm4) {
    const int8_t* xq = static_cast<const int8_t*>(xv);
    for (int i = tid; i < kRowsM * gs; i += kThreads) {
      const int m = i / gs, k = i % gs;
      xqs[m * kXqLd + k] = m < rows ? xq[(size_t)(m0 + m) * K + k_grp + k] : int8_t(0);
    }
  } else {
    const bf16* x = static_cast<const bf16*>(xv);
    for (int i = tid; i < kRowsM * gs; i += kThreads) {
      const int m = i / gs, k = i % gs;
      xs[m * kXLd + k] = m < rows ? x[(size_t)(m0 + m) * K + k_grp + k] : __float2bfloat16(0.f);
    }
  }

  const int k_steps = gs / kChunkK;                 // chunks per column strip
  const int n_chunks = (block_n / kChunkN) * k_steps;
  // chunk c: column strip c / k_steps, K rows (c % k_steps) * 32 of the group
  auto load = [&](int c) {
    if (c < n_chunks) {
      const int r = tid >> 3, q = tid & 7;  // one 16-byte piece per thread
      const int k = k_grp + (c % k_steps) * kChunkK + r;
      const int n = n_tile + (c / k_steps) * kChunkN + q * 16;
      cp_async16(&stage[c % kStages][r * kStageLd + q * 16], qw + (size_t)k * N + n);
    }
    cp_async_commit();  // an empty group past the end keeps the wait count uniform
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load(c);

  float accf[4] = {0.f, 0.f, 0.f, 0.f};
  int acci[4] = {0, 0, 0, 0};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's piece of chunk c has landed
    __syncthreads();               // every piece is visible; chunk c - 1's readers are done
    load(c + kStages - 1);         // into the stage chunk c - 1 held
    const int8_t* st = stage[c % kStages];
    const int kk = (c % k_steps) * kChunkK;  // K offset inside the group
    if (kk == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) accf[i] = 0.f, acci[i] = 0;
    }
    if constexpr (kMode == kQmm2) {
      {  // widen this thread's 16 bytes into the bf16 tile
        const int r = tid >> 3, q = tid & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(st + r * kStageLd + q * 16);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float f[4];
          s8x4_to_f32(w[i], f);
          o[2 * i] = pack_bf16(f[0], f[1]);
          o[2 * i + 1] = pack_bf16(f[2], f[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>(tile + r * kTileLd + q * 16);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int i = lane >> 3, r = lane & 7;
        uint32_t a[4];
        ldsm_x4_trans(a, tile + (s * 16 + r + 8 * (i >> 1)) * kTileLd + warp * 16 + 8 * (i & 1));
        const bf16* xr = xs + g8 * kXLd + kk + s * 16 + 2 * t4;
        mma16816(accf, a, *reinterpret_cast<const uint32_t*>(xr),
                 *reinterpret_cast<const uint32_t*>(xr + 8));
      }
    } else {
      uint32_t r[4];  // K rows 8i..8i+7 of this warp's 16 columns, b16 units transposed
      ldsm_x4_trans(r, st + lane * kStageLd + warp * 16);
      if constexpr (kMode == kQmm3) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4];
          widen_pairs(r[2 * s], a[0], a[1]);
          widen_pairs(r[2 * s + 1], a[2], a[3]);
          const bf16* xr = xs + g8 * kXLd + kk + s * 16 + 2 * t4;
          mma16816(accf, a, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      } else {
        const uint32_t a[4] = {__byte_perm(r[0], r[1], 0x6420), __byte_perm(r[0], r[1], 0x7531),
                               __byte_perm(r[2], r[3], 0x6420), __byte_perm(r[2], r[3], 0x7531)};
        const int8_t* xr = xqs + g8 * kXqLd + kk + 2 * t4;
        const uint32_t b0 = uint32_t(*reinterpret_cast<const uint16_t*>(xr)) |
                            (uint32_t(*reinterpret_cast<const uint16_t*>(xr + 8)) << 16);
        const uint32_t b1 = uint32_t(*reinterpret_cast<const uint16_t*>(xr + 16)) |
                            (uint32_t(*reinterpret_cast<const uint16_t*>(xr + 24)) << 16);
        mma_s8(acci, a, b0, b1);
      }
    }
    if (kk + kChunkK == gs) {
      // the strip's group partial: C rows are columns, C columns are rows of x
      const int nb = n_tile + (c / k_steps) * kChunkN + warp * 16;
      const int n_lo = kMode == kQmm2 ? nb + g8 : nb + 2 * g8;
      const int n_hi = kMode == kQmm2 ? nb + g8 + 8 : nb + 2 * g8 + 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = h ? n_hi : n_lo;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 2 * t4 + j;
          if (m < rows) {
            const size_t at = ((size_t)grp * M + m0 + m) * N + n;
            if constexpr (kMode == kQmm4) {
              static_cast<int*>(ws)[at] = acci[2 * h + j];
            } else {
              static_cast<float*>(ws)[at] = accf[2 * h + j];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The second launch: one block per (128-column strip, row tile) applies the
// scales and sums the strip's group partials in group order.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
qmm_reduce_kernel(const void* __restrict__ ws, const float* __restrict__ scales,
                  const float* __restrict__ sx, float* __restrict__ out, int M, int N, int groups) {
  const int m0 = blockIdx.y * kRowsM;
  reduce_strip<kMode>(ws, scales, sx, out, M, N, m0, min(kRowsM, M - m0), blockIdx.x * kChunkN,
                      groups);
}

template <int kMode>
int launch(const void* x, const void* sx, const void* qw, const void* scales, void* out, void* ws,
           int M, int K, int N, int G, int block_n, void* stream) {
  const int row_tiles = (M + kRowsM - 1) / kRowsM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qmm_group_kernel<kMode><<<dim3(N / block_n, row_tiles, G), kThreads, 0, s>>>(
      x, static_cast<const int8_t*>(qw), ws, M, K, N, K / G, block_n);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  qmm_reduce_kernel<kMode><<<dim3(N / kChunkN, row_tiles), kThreads, 0, s>>>(
      ws, static_cast<const float*>(scales), static_cast<const float*>(sx), static_cast<float*>(out),
      M, N, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types and contiguity, and
// that K / G is a multiple of 32 and at most 512, block_n a multiple of 128
// dividing N. ws holds G * M * N floats (qmm4: ints); out (M, N) fp32. Two
// launches on ``stream`` (the group partials, then their ordered sum); each
// returns the first cudaGetLastError() that is not 0.
DS_EXPORT int qmm2_launch(const void* x, const void* qw, const void* scales, void* out, void* ws,
                          int M, int K, int N, int G, int block_n, void* stream) {
  return launch<kQmm2>(x, nullptr, qw, scales, out, ws, M, K, N, G, block_n, stream);
}

DS_EXPORT int qmm3_launch(const void* x, const void* qw, const void* scales, void* out, void* ws,
                          int M, int K, int N, int G, int block_n, void* stream) {
  return launch<kQmm3>(x, nullptr, qw, scales, out, ws, M, K, N, G, block_n, stream);
}

// xq (M, K) int8 and sx (M,) fp32: the rows' dynamic activation quantization
DS_EXPORT int qmm4_launch(const void* xq, const void* sx, const void* qw, const void* scales,
                          void* out, void* ws, int M, int K, int N, int G, int block_n,
                          void* stream) {
  return launch<kQmm4>(xq, sx, qw, scales, out, ws, M, K, N, G, block_n, stream);
}
