// Kernel A of the fused decode layer: norm1(x) @ dequant(Wqkv) + bias, then
// RoPE on the q and k head segments, for one token per row.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_block.py::
// _qkv_ln_kernel. Same arithmetic: norm1 of each row in fp32 (two-pass
// variance for layernorm, mean square for rmsnorm), cast to bf16 (the
// compute dtype) before the dot; int8 weights widen in registers; each
// quantization group's fp32 partial is multiplied by its scale row; the bias
// is added and the rotation applied in fp32, and the result is cast last.
//
// Layout (the JAX one): x (M, K) bf16; norms (4, K) fp32, rows 0 and 1 used;
// w (K, N) int8 with N = (nh + 2 nkv) hd in [q;k;v] order; scales (G, N);
// bias (N,) fp32; sin, cos (M, hd/2) fp32 at each row's position; out (M, N)
// bf16. Columns below rot_cols (the q and k heads) are rotated, half-split.
//
// What bounds it on the H100: the weight bytes, K*N int8 plus the scales,
// over 3.35 TB/s (gpt2-large: about 5.2 MB, 1.55 us).
//
// Design: the TPU kernel walks K along a sequential grid axis with the whole
// normalized x in VMEM. Here the grid is (column tiles, row tiles, K splits),
// sized by the wrapper to the blocks the 132 SMs hold at once
// (resident_blocks). Every block takes the norm statistics of its rows itself
// (one warp a row, x read through L2; the second pass hits L1) and
// normalizes x as it stages it, 128 K-rows at a time, while the chunk's
// weight loads are in flight (int8_stream.cuh); the normalized rows are
// never written anywhere. The last block of a column tile to arrive sums the
// splits in split order, adds the bias and rotates. A column tile is 128
// columns: with a head dim that divides 128 it holds whole heads, so both
// halves of every rotated pair are in that block's shared memory.

#include "int8_stream.cuh"

namespace {

using namespace int8s;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
qkv_ln_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ norms,
              const int8_t* __restrict__ w, const float* __restrict__ scales,
              const float* __restrict__ bias, const float* __restrict__ sin_t,
              const float* __restrict__ cos_t, __nv_bfloat16* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ arrivals, int M, int K, int N, int gs,
              int k_per_split, float eps, int rms, int rot_cols, int hd) {
  __shared__ Smem sm;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const int n_base = blockIdx.x * kBlockN;
  const int splits = gridDim.z;
  const int k_lo = blockIdx.z * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);

  // norm1 statistics of this block's rows: warp r takes row m0 + r
  const int warp = threadIdx.x / 32;
  if (warp < rows) {
    const uint2* xr = reinterpret_cast<const uint2*>(x + (size_t)(m0 + warp) * K);
    warp_row_stats(
        [&](int j) {  // 4 bf16 values in 8 bytes
          const uint2 u = __ldg(xr + j);
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          return make_float4(a.x, a.y, b.x, b.y);
        },
        K, eps, rms, &sm.mu[warp], &sm.rstd[warp]);
  }
  __syncthreads();

  const float* n_scale = norms;
  const float* n_bias = norms + K;  // zeros for rmsnorm
  auto stage = [&](int m, int k) {
    const float v = __bfloat162float(__ldg(x + (size_t)(m0 + m) * K + k));
    return round_bf16((v - sm.mu[m]) * sm.rstd[m] * n_scale[k] + n_bias[k]);
  };
  stream_split(stage, w, scales, N, gs, n_base, rows, k_lo, k_hi,
               ws + ((size_t)blockIdx.z * M + m0) * N, sm);
  if (!arrive(&arrivals[blockIdx.y * gridDim.x + blockIdx.x], splits, sm)) return;
  sum_splits(ws, splits, M, N, m0, n_base, rows, sm.fin[0]);

  const int half = hd / 2;
  for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = n_base + col;
    if (m >= rows || n >= N) continue;
    float y = sm.fin[0][m][col] + bias[n];
    if (n < rot_cols) {
      const int j = n % hd;
      const float* sr = sin_t + (size_t)(m0 + m) * half;
      const float* cr = cos_t + (size_t)(m0 + m) * half;
      if (j < half) {  // first half: a cos - b sin, b the partner hd/2 columns on
        const float b = sm.fin[0][m][col + half] + bias[n + half];
        y = y * cr[j] - b * sr[j];
      } else {         // second half: b cos + a sin, a the partner hd/2 columns back
        const float a = sm.fin[0][m][col - half] + bias[n - half];
        y = y * cr[j - half] + a * sr[j - half];
      }
    }
    out[(size_t)(m0 + m) * N + n] = __float2bfloat16(y);
  }
}

}  // namespace

// The blocks of qkv_ln_kernel that the current device holds at once: SMs x
// blocks per SM at this kernel's registers and shared memory.
DS_EXPORT int resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qkv_ln_kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

// Device pointers; the caller checked shapes, types, contiguity, K % 4 == 0,
// N % 4 == 0, 16-byte alignment and (with rot_cols > 0) 128 % hd == 0. ws holds
// splits * M * N floats; arrivals one zeroed int per (column, row) tile,
// left zeroed. Returns cudaGetLastError().
DS_EXPORT int qkv_ln_launch(const void* x, const void* norms, const void* w, const void* scales,
                            const void* bias, const void* sin_t, const void* cos_t, void* out,
                            void* ws, void* arrivals, int M, int K, int N, int G, int splits,
                            int k_per_split, float eps, int rms, int rot_cols, int hd,
                            void* stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kRows - 1) / kRows, splits);
  qkv_ln_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(norms),
      static_cast<const int8_t*>(w), static_cast<const float*>(scales),
      static_cast<const float*>(bias), static_cast<const float*>(sin_t),
      static_cast<const float*>(cos_t), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(arrivals), M, K, N, K / G, k_per_split, eps,
      rms, rot_cols, hd);
  return static_cast<int>(cudaGetLastError());
}
