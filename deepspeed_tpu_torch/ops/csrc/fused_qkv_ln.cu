// Kernel A of the fused decode layer: norm1(x) @ dequant(Wqkv) + bias, then
// RoPE on the q and k head segments, for every row the scheduler gives it
// (decode, verify and chunk steps alike).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_block.py::
// _qkv_ln_kernel. Same arithmetic: norm1 of each row in fp32 (two-pass
// variance for layernorm, mean square for rmsnorm), cast to bf16 (the
// compute dtype) before the dot; int8 weights widen to bf16 in registers;
// each quantization segment's fp32 partial is multiplied by its scale row;
// the bias is added and the rotation applied in fp32, and the result is
// cast last.
//
// Layout (the JAX one): x (M, K) bf16; norms (4, K) fp32, rows 0 and 1 used;
// w (K, N) int8 with N = (nh + 2 nkv) hd in [q;k;v] order; scales (G, N);
// bias (N,) fp32; sin, cos (M, hd/2) fp32 at each row's position; out (M, N)
// bf16. Columns below rot_cols (the q and k heads) are rotated, half-split.
//
// What bounds it on the H100: at decode the weight bytes, K*N int8 plus the
// scales, over 3.35 TB/s (gpt2-large 5.2 MB, 1.55 us); at the chunk step
// (M = 512) the 2*M*K*N operations over the 989 TFLOP/s of the bf16 tensor
// cores (5.0 GFLOP, 5.1 us).
//
// Design. Two launches in stream order (three with a split wgmma plan),
// issued by one call, with programmatic dependent launch:
//  1. the norm pass (fused_layer.cuh): a block a row writes norm1(x) as bf16
//     to a workspace (M x K, 1.3 MB at gpt2-large M = 512, read back from
//     L2);
//  2. the product on qmm_core.cuh's mainloops, the same code and the same
//     sum as quant_matmul: mma.sync at M <= 32 (K split over blocks; a
//     tile's last block chains the segment partials in order and runs the
//     epilogue), wgmma with TMA-fed tiles at M > 32 (the chain in
//     registers; partials and an ordered reduce launch where the row tiles
//     alone leave the card idle). The wrapper's plan picks the tile and the
//     split; a row's bits depend on neither.
// The epilogue (bias, RoPE, the cast) sees the block's finished tile in
// shared memory: at hd = 128 a rotated pair spans the two 64-column
// warpgroups of a 128-column block, and each element reads its partner
// there. A 128-column tile holds whole heads when hd divides 128.
//   Normalizing in the prologue, not in shared memory as x's tile arrives,
// by measurement: the tile comes by TMA straight into the swizzled layout
// wgmma reads, and a row's statistics need the whole row before its first
// tile, so the in-tile variant would take every block's statistics of its
// rows again (a read of M x K per column tile) and a pass over each staged
// tile; it could save at most the norm pass and the epilogue, the call less
// quant_matmul's product on the normalized rows: 0.0272 - 0.0200 ms at
// gpt2-large M = 512 (chip_smoke.py's product_ms, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md §6), a quarter of the call.

#include "fused_layer.cuh"

namespace {

using namespace ds_qmm;

struct QkvEpi {  // columns n, n + 1 of row m: bias, then RoPE on the q and k heads
  static constexpr bool kStaged = true;
  static constexpr int kPasses = 1;
  const float* bias;
  const float* sin_t;
  const float* cos_t;
  bf16* out;
  int N, rot_cols, hd;
  __device__ __forceinline__ void operator()(const Fin& f, int r, int c, int m, int n) const {
    const float2 b = ds_fused::ldg2(bias + n);
    float y0 = __fadd_rn(f(0, r, c), b.x), y1 = __fadd_rn(f(0, r, c + 1), b.y);
    if (n < rot_cols) {  // hd and hd / 2 are even: n, n + 1 lie in one half of a head
      const int half = hd >> 1, j = n % hd;
      const int k = j < half ? j : j - half, d = j < half ? half : -half;
      const float2 p = ds_fused::ldg2(bias + n + d);  // the partner pair hd / 2 away
      const float p0 = __fadd_rn(f(0, r, c + d), p.x), p1 = __fadd_rn(f(0, r, c + d + 1), p.y);
      const float2 cs = ds_fused::ldg2(cos_t + (size_t)m * half + k);
      const float2 sn = ds_fused::ldg2(sin_t + (size_t)m * half + k);
      if (j < half) {  // first half: a cos - b sin, b the partner
        y0 = __fsub_rn(__fmul_rn(y0, cs.x), __fmul_rn(p0, sn.x));
        y1 = __fsub_rn(__fmul_rn(y1, cs.y), __fmul_rn(p1, sn.y));
      } else {  // second half: b cos + a sin, a the partner
        y0 = __fadd_rn(__fmul_rn(y0, cs.x), __fmul_rn(p0, sn.x));
        y1 = __fadd_rn(__fmul_rn(y1, cs.y), __fmul_rn(p1, sn.y));
      }
    }
    ds_fused::st2(out + (size_t)m * N + n, y0, y1);
  }
};

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, K % 4 == 0,
// N % 4 == 0, 16-byte alignment and (with rot_cols > 0) 128 % hd == 0. xn
// holds M * K bf16 (the normalized rows); ws the segment partials of a
// split plan (segments * M * N floats; null when the plan has none); flags
// one zeroed int a block tile of the mma.sync plans, left zeroed. bm and
// splits: the plan (ops/decode_block.py::_plan). plant: a check of the
// invariance gate, 0 on the main path. Returns the first launch error.
DS_EXPORT int qkv_ln_launch(const void* x, const void* norms, const void* w, const void* scales,
                            const void* bias, const void* sin_t, const void* cos_t, void* out,
                            void* xn, void* ws, void* flags, int M, int K, int N, int G, int bm, int splits,
                            float eps, int rms, int rot_cols, int hd, int plant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* nrm = static_cast<const float*>(norms);
  if (const int rc = ds_fused::launch_norm(static_cast<const bf16*>(x), nrm, nrm + K,
                                           static_cast<bf16*>(xn), M, K, eps, rms, s))
    return rc + 30000;
  const Operands op = ds_fused::make_ops(xn, w, scales, nullptr, nullptr, ws, flags, M, K, N, G);
  const QkvEpi epi{static_cast<const float*>(bias), static_cast<const float*>(sin_t),
                   static_cast<const float*>(cos_t), static_cast<bf16*>(out), N, rot_cols, hd};
  return ds_qmm::run_product(op, epi, bm, splits, plant, s);
}
