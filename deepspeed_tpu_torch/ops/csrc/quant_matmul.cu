// w8a16 quantized matmul for Hopper: out = x @ dequant(qw, scales).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/quant_matmul.py::_qmm_kernel.
// Same arithmetic: int8 weights widen in registers (the bf16 weight never
// exists in memory), products accumulate in fp32 per quantization group, and
// each group's partial sum is multiplied by that group's fp32 scale row.
//
// Layout (the JAX one): x (M, K) bf16 row-major; qw (K, N) int8; scales
// (G, N) fp32 with group size gs = K / G; out (M, N) bf16 or fp32.
//
// What bounds it on the H100: at decode (M = 8) the weight bytes, K*N, over
// 3.35 TB/s; at prefill (M = 1024) the 2*M*K*N multiply-adds, which this
// CUDA-core kernel runs far below the 989 TFLOP/s tensor-core peak (a
// tensor-core version is later work).
//
// Design: a block owns 8 rows of x, 128 columns of N and a range of K. Its
// 8 warps are 8 slices of K; a warp's 32 lanes take 4 adjacent columns each,
// so every weight load of a warp is one contiguous 128-byte row segment
// (32-byte segments measured ~250 GB/s: device memory wants long bursts).
// All 8 rows of x stay in registers per thread, so every int8 byte read
// feeds 8 multiply-adds. x is staged in shared memory 64 K-rows at a time.
// A K slice multiplies its own per-group partial by the group's scale (the
// scale distributes over the slice sum), and the 8 slices are summed in
// shared memory in a fixed order. The TPU's sequential K grid axis becomes
// the loop over groups inside the block. At decode a grid of N/128 blocks
// cannot fill 132 SMs, so K is cut into splits (ranges of whole staged
// chunks); each split's 8 slices sum to one fp32 partial, and a row's
// result is 0 + partial_0 + partial_1 + ... in split order. No atomics touch
// the values, so the result is the same on every run.
//
// Batch invariance: the wrapper picks the split plan from the weight's shape
// (K, N) alone, never from M, so a row's sums run in the same order whatever
// else shares the call (the scheduler's chunk step at M = slots x chunk and
// its decode step at M = slots give a row the same bits). Only where the
// splits run follows M: while the (n, m) tile grid is too small to fill the
// card, each split is a block of its own (grid z) that writes its partial to
// a workspace and the last block of a tile to arrive sums them; once the
// tile grid fills the card, each block walks its tile's splits in order and
// keeps the running sums in registers (no (splits, M, N) workspace). Both
// add the same partials in the same order.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;           // rows of x per block
constexpr int kCols = 4;           // adjacent N columns per thread
constexpr int kTx = 32;            // threads across N: a warp reads 128 contiguous bytes
constexpr int kBlockN = kTx * kCols;
constexpr int kSlices = kThreads / kTx;  // K slices per block (one per warp)
constexpr int kChunk = 64;         // K rows of x staged per pass

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One split's contribution to a thread's 8 x 4 outputs: every quantization
// group that meets the K range [k_lo, k_hi), each group's fp32 partial times
// its scale row, summed in group order into acc.
__device__ __forceinline__ void split_partial(const __nv_bfloat16* __restrict__ x,
                                              const int8_t* __restrict__ qw,
                                              const float* __restrict__ scales,
                                              float (&xs)[kRows][kChunk], float (&acc)[kRows][kCols],
                                              int k_lo, int k_hi, int K, int N, int gs, int n0,
                                              int m0, int rows, bool live, int ty) {
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int g0 = k_lo / gs * gs; g0 < k_hi; g0 += gs) {
    const int a = max(g0, k_lo), b = min(g0 + gs, k_hi);
    float part[kRows][kCols];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[m][c] = 0.f;

    for (int k0 = a; k0 < b; k0 += kChunk) {
      const int kc = min(kChunk, b - k0);
      // issue the chunk's weight loads first: they do not wait for x, and a
      // thread keeps kIters of them in flight instead of one
      constexpr int kIters = kChunk / kSlices;
      char4 w[kIters];
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int kk = ty + it * kSlices;
        w[it] = (live && kk < kc)
                    ? __ldg(reinterpret_cast<const char4*>(qw + (size_t)(k0 + kk) * N + n0))
                    : make_char4(0, 0, 0, 0);
      }
      __syncthreads();  // the previous chunk's readers are done with xs
      for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
        const int m = i / kChunk, kk = i % kChunk;
        xs[m][kk] = (m < rows && kk < kc)
                        ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + kk])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int kk = ty + it * kSlices;  // rows past kc carry zero weights
        const float wf[kCols] = {static_cast<float>(w[it].x), static_cast<float>(w[it].y),
                                 static_cast<float>(w[it].z), static_cast<float>(w[it].w)};
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < kCols; ++c) part[m][c] = fmaf(xv, wf[c], part[m][c]);
        }
      }
    }
    if (live) {
      // the group's scale distributes over the partial sums of its rows
      const float4 s =
          __ldg(reinterpret_cast<const float4*>(scales + (size_t)(g0 / gs) * N + n0));
      const float sv[kCols] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][c] += part[m][c] * sv[c];
    }
  }
}

// kSeq: each block walks all of its tile's splits in order, keeping the
// running sums in shared memory; else a block computes the split of its
// grid z (the only one when the plan has one).
template <typename OutT, bool kSeq>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ qw,
           const float* __restrict__ scales, OutT* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ arrivals, int M, int K, int N, int gs, int splits,
           int k_per_split) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kSlices][kRows][kBlockN + 1];
  __shared__ float total[kSeq ? kRows : 1][kBlockN];  // kSeq: the running sums
  __shared__ bool last_arrival;

  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kBlockN + tx * kCols;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const bool live = n0 < N;  // N % 4 == 0, so a thread's 4 columns are all in or all out
  float acc[kRows][kCols];

  if constexpr (kSeq) {
    for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads)  // a thread's own sums
      total[i / kBlockN][i % kBlockN] = 0.f;
    for (int z = 0; z < splits; ++z) {
      split_partial(x, qw, scales, xs, acc, z * k_per_split, min(K, (z + 1) * k_per_split), K,
                    N, gs, n0, m0, rows, live, ty);
      __syncthreads();  // the previous split's readers are done with red
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) red[ty][m][tx * kCols + c] = acc[m][c];
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
        const int m = i / kBlockN, col = i % kBlockN;
        float s = 0.f;
        for (int k = 0; k < kSlices; ++k) s += red[k][m][col];  // fixed order
        total[m][col] += s;  // split order from 0, as the spread path sums
      }
    }
    for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
      const int m = i / kBlockN, col = i % kBlockN;
      const int n = blockIdx.x * kBlockN + col;
      if (m < rows && n < N) out[(size_t)(m0 + m) * N + n] = to_out<OutT>(total[m][col]);
    }
    return;
  }

  const int k_lo = blockIdx.z * k_per_split;
  split_partial(x, qw, scales, xs, acc, k_lo, min(K, k_lo + k_per_split), K, N, gs, n0, m0, rows,
                live, ty);
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[ty][m][tx * kCols + c] = acc[m][c];
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m < rows && n < N) {
      float s = 0.f;
      for (int k = 0; k < kSlices; ++k) s += red[k][m][col];  // fixed order
      if (splits == 1) {
        out[(size_t)(m0 + m) * N + n] = to_out<OutT>(s);
      } else {
        ws[((size_t)blockIdx.z * M + m0 + m) * N + n] = s;
      }
    }
  }
  if (splits == 1) return;

  // spread splits: the last block of this (n, m) tile to arrive sums the
  // splits' partials in split order, so the result does not depend on
  // arrival order
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last_arrival = atomicAdd(&arrivals[tile], 1) == splits - 1;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = blockIdx.x * kBlockN + col;
    if (m < rows && n < N) {
      float s = 0.f;
      for (int z = 0; z < splits; ++z) s += __ldcg(&ws[((size_t)z * M + m0 + m) * N + n]);
      out[(size_t)(m0 + m) * N + n] = to_out<OutT>(s);
    }
  }
  if (threadIdx.x == 0) arrivals[tile] = 0;  // ready for the next launch
}

}  // namespace

// x, qw, scales, out: device pointers; the caller checked shapes, types,
// contiguity, N % 4 == 0 and 16-byte alignment. The plan: ``splits`` K
// ranges of ``k_per_split`` rows. ``spread``: one block per split (grid z =
// splits), ws holding splits * M * N floats and arrivals one zeroed int per
// (n, m) tile (the kernel leaves it zeroed); else each block walks its
// tile's splits in order and ws/arrivals may be null. Returns
// cudaGetLastError().
DS_EXPORT int qmm_launch(const void* x, const void* qw, const void* scales, void* out,
                         void* ws, void* arrivals, int M, int K, int N, int G, int splits,
                         int k_per_split, int spread, int out_f32, void* stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kRows - 1) / kRows,
                  spread && splits > 1 ? splits : 1);
  const int gs = K / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(qw);
  const auto* sp = static_cast<const float*>(scales);
  auto* wsp = static_cast<float*>(ws);
  auto* ap = static_cast<int*>(arrivals);
  auto* of = static_cast<float*>(out);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool seq = !spread && splits > 1;
  if (out_f32 && seq) {
    qmm_kernel<float, true><<<grid, kThreads, 0, s>>>(xp, wp, sp, of, wsp, ap, M, K, N, gs, splits,
                                                      k_per_split);
  } else if (out_f32) {
    qmm_kernel<float, false><<<grid, kThreads, 0, s>>>(xp, wp, sp, of, wsp, ap, M, K, N, gs, splits,
                                                       k_per_split);
  } else if (seq) {
    qmm_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, s>>>(xp, wp, sp, ob, wsp, ap, M, K, N, gs,
                                                              splits, k_per_split);
  } else {
    qmm_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(xp, wp, sp, ob, wsp, ap, M, K, N, gs,
                                                               splits, k_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
