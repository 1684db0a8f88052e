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
// Design: the two mainloops, the segment sum and its batch invariance are
// qmm_core.cuh's (shared with kernels A and C of the fused decode layer);
// this file picks the plan and stores the finished sums as they are.
//   M > 32 (prefill, chunk steps): wgmma m64n128k16, 128 columns x 128 rows
// of x a block, the chain in registers; the weight is read and widened once
// per 128 rows of x.
//   M <= 32 (decode, verify): mma.sync m16n8k16, 8, 16 or 32 rows a block,
// and K split over blocks so that about two blocks per SM stream weight
// bytes (the wrapper's split plan, a function of the weight's shape): the
// segment partials go to a workspace and qmm_reduce_kernel runs the chain.
//   A shape the wide path cannot take (N % 16, gs % 128) runs the narrow
// path at every M. A row's bits never depend on M (qmm_core.cuh): held on
// the card by the invariance checks (rows of M = 1, 8, 16, 32 against M =
// 33, 64, 65, 512, 1024 at gpt2-large's and llama3-8b's shapes, in
// chip_smoke.py and tests/test_torch_kernels_cuda.py).

#include "qmm_core.cuh"

namespace {

using namespace ds_qmm;

// the finished pair of columns (n, n + 1) of row m, stored as they are
template <typename OutT>
struct StoreEpi {
  static constexpr bool kStaged = false;
  static constexpr int kPasses = 1;
  OutT* out;
  int N;
  __device__ __forceinline__ void pair(int m, int n, float a, float b) const {
    store2(out + (size_t)m * N + n, a, b);
  }
};

// M <= 32: mma.sync, K split over `splits` blocks (the segment partials and
// the ordered second launch) or, with one split, the chain in registers
template <int TM, typename OutT>
int narrow(const Operands& op, const StoreEpi<OutT>& epi, int splits, int vec, cudaStream_t s) {
  if (splits == 1) return launch_narrow<TM, true>(op, epi, 1, vec, s);
  if (const int rc = launch_narrow<TM, false>(op, NoEpi{}, splits, vec, s)) return rc;
  return launch_reduce(op, epi, s);
}

template <typename OutT>
int launch(const Operands& op, OutT* out, int splits, int vec, cudaStream_t s) {
  const StoreEpi<OutT> epi{out, op.N};
  if (op.M <= 8) return narrow<1>(op, epi, splits, vec, s);
  if (op.M <= 16) return narrow<2>(op, epi, splits, vec, s);
  // the wide path's TMA boxes want 16-byte rows (N % 16, K % 8) and whole
  // 128-row segments; any other shape runs the narrow path at every M
  if (op.M <= 32 || !wide_ok(op, vec)) return narrow<4>(op, epi, splits, vec, s);
  return launch_wide<128, true>(op, epi, 1, s);
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
  const Operands op{static_cast<const bf16*>(x),
                    {static_cast<const int8_t*>(qw), nullptr},
                    {static_cast<const float*>(scales), nullptr},
                    static_cast<float*>(ws), nullptr, M, K, N, gs, spg, G * spg, 1};
  const int vec = N % 16 == 0 && gs % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch(op, static_cast<float*>(out), splits, vec, s)
                 : launch(op, static_cast<bf16*>(out), splits, vec, s);
}
