// Kernel C of the fused decode layer, for one token per row:
//   res2  = attn @ dequant(Wo) + o_bias + x                       (fp32)
//   h     = act(norm2(res2) @ dequant(Wup) + up_bias)             (ungated)
//         | act(norm2(res2) @ dequant(Wgate) + gate_bias) * (norm2(res2) @ dequant(Wup) + up_bias)
//   out   = res2 + h @ dequant(Wdown) + down_bias                 (cast to bf16 last)
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_block.py::
// _out_mlp_kernel. Same arithmetic: res2 stays fp32; norm2 is taken in fp32
// and cast to bf16 before the up (and gate) dot; each quantization group's
// fp32 partial is multiplied by its scale row; the activation (silu for
// swiglu, tanh gelu for geglu) applies to the gate; h is cast to bf16 before
// the down dot. One difference, by design: the TPU kernel keeps the up and
// gate partial sums in bf16 between k-blocks; here they stay fp32.
//
// Layout (the JAX one): attn (M, Ko) bf16; x (M, H) bf16; norms (4, H) fp32,
// rows 2 and 3 used; o (Ko, H), up and gate (H, F), down (F, H) int8 with
// (G, N) fp32 scales and (N,) fp32 biases; out (M, H) bf16.
//
// What bounds it on the H100: the weight bytes, Ko*H + (2 or 3)*H*F int8 plus
// scales, over 3.35 TB/s (gpt2-large: about 15.2 MB, 4.55 us; llama3-8b:
// about 193 MB, 59 us).
//
// Design: norm2 needs every column of the o projection, and the down
// projection every column of the activation, so the TPU kernel runs its
// phases in order along one sequential grid axis; on Hopper that would be
// one SM. Here one cooperative launch keeps every block co-resident (the
// wrapper sizes the grid from the occupancy query) and splits each phase's
// weight stream over all of them: a phase's work items are (column tile,
// row tile, K split), each streamed as in int8_stream.cuh, and the last
// block of a tile to arrive sums its splits in split order and applies the
// phase's epilogue (bias and residual; bias and activation; bias and
// residual and the cast). Between phases, grid.sync(); before it each block
// asks L2 for the first chunk of its next phase's weights, which do not
// wait for the barrier. res2 (M x H fp32) and the activation (M x F bf16)
// live in a global workspace that stays in L2, read back with __ldcg (they
// are written during this launch, so never through the non-coherent
// read-only path). Each block takes the norm2 statistics of the rows it
// works on itself (one warp a row), which costs one read of M x H floats
// from L2 per block and saves a grid-wide barrier. No float atomics: the
// result is the same on every run.

#include <cooperative_groups.h>

#include "int8_stream.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace int8s;

struct Proj {
  const int8_t* w;
  const float* s;
  const float* b;
  int K, gs, splits, k_per;
};

struct Args {
  const __nv_bfloat16* attn;
  const __nv_bfloat16* x;
  const float* norms;
  Proj o, up, gate, down;  // gate.w is null for an ungated MLP
  __nv_bfloat16* out;
  float* res2;
  __nv_bfloat16* up_h;
  float *ws_o, *ws_u, *ws_g, *ws_d;
  int *arr_o, *arr_u, *arr_d;
  int M, H, F, act, rms;
  float eps;
};

__device__ __forceinline__ float activate(float h, int act) {
  switch (act) {
    case 0:  // gelu, tanh approximation
      return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
    case 1:  // gelu, erf
      return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
    case 2:  // quick_gelu
      return h / (1.f + expf(-1.702f * h));
    case 3:  // silu
      return h / (1.f + expf(-h));
    default:  // relu
      return fmaxf(h, 0.f);
  }
}

__device__ __forceinline__ float load_bf16_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// A phase's work item: (column tile, row tile, K split); consecutive items
// are the splits of one tile.
struct Item {
  int tile, m0, rows, n_base, k_lo, k_hi, z;
};

__device__ __forceinline__ Item item_of(int it, const Proj& p, int M, int N) {
  const int tiles_n = (N + kBlockN - 1) / kBlockN;
  Item r;
  r.z = it % p.splits;
  r.tile = it / p.splits;
  r.m0 = (r.tile / tiles_n) * kRows;
  r.rows = min(kRows, M - r.m0);
  r.n_base = (r.tile % tiles_n) * kBlockN;
  r.k_lo = r.z * p.k_per;
  r.k_hi = min(p.K, r.k_lo + p.k_per);
  return r;
}

__device__ __forceinline__ int items_of(const Proj& p, int M, int N) {
  return ((N + kBlockN - 1) / kBlockN) * ((M + kRows - 1) / kRows) * p.splits;
}

// The first weight rows of this block's first item of a phase, into L2: the
// weights do not wait for the previous phase, so they stream while the block
// waits at the barrier.
__device__ __forceinline__ void prefetch_first(const Proj& p, int M, int N) {
  if (p.w == nullptr || (int)blockIdx.x >= items_of(p, M, N)) return;
  const Item t = item_of(blockIdx.x, p, M, N);
  prefetch_rows(p.w, N, t.n_base, t.k_lo, min(t.k_hi, t.k_lo + (kStages - 1) * kChunk));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) out_mlp_kernel(const Args a) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int M = a.M, H = a.H, F = a.F;
  const bool gated = a.gate.w != nullptr;

  // phase 1: res2 = attn @ o + o_bias + x
  for (int it = blockIdx.x, n_it = items_of(a.o, M, H); it < n_it; it += gridDim.x) {
    const Item t = item_of(it, a.o, M, H);
    const __nv_bfloat16* attn = a.attn + (size_t)t.m0 * a.o.K;
    const int Ko = a.o.K;
    stream_split([&](int m, int k) { return __bfloat162float(attn[(size_t)m * Ko + k]); }, a.o.w,
                 a.o.s, H, a.o.gs, t.n_base, t.rows, t.k_lo, t.k_hi,
                 a.ws_o + ((size_t)t.z * M + t.m0) * H, sm);
    if (!arrive(&a.arr_o[t.tile], a.o.splits, sm)) continue;
    sum_splits(a.ws_o, a.o.splits, M, H, t.m0, t.n_base, t.rows, sm.fin[0]);
    for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
      const int m = i / kBlockN, col = i % kBlockN, n = t.n_base + col;
      if (m >= t.rows || n >= H) continue;
      const size_t at = (size_t)(t.m0 + m) * H + n;
      a.res2[at] = (sm.fin[0][m][col] + a.o.b[n]) + __bfloat162float(a.x[at]);
    }
  }
  prefetch_first(a.up, M, F);
  prefetch_first(a.gate, M, F);
  grid.sync();

  // phase 2: up_h = act(norm2(res2) @ up + up_bias), or the gated form
  const float* n_scale = a.norms + 2 * H;
  const float* n_bias = a.norms + 3 * H;  // zeros for rmsnorm
  int stats_m0 = -1;
  for (int it = blockIdx.x, n_it = items_of(a.up, M, F); it < n_it; it += gridDim.x) {
    const Item t = item_of(it, a.up, M, F);
    if (t.m0 != stats_m0) {  // norm2 statistics of this item's rows: warp r takes row m0 + r
      __syncthreads();        // no thread still stages with the previous rows' statistics
      const int warp = threadIdx.x / 32;
      if (warp < t.rows) {
        const float4* r = reinterpret_cast<const float4*>(a.res2 + (size_t)(t.m0 + warp) * H);
        warp_row_stats([&](int j) { return __ldcg(r + j); }, H, a.eps, a.rms, &sm.mu[warp],
                       &sm.rstd[warp]);
      }
      __syncthreads();
      stats_m0 = t.m0;
    }
    const float* res = a.res2 + (size_t)t.m0 * H;
    auto stage = [&](int m, int k) {
      const float v = __ldcg(res + (size_t)m * H + k);
      return round_bf16((v - sm.mu[m]) * sm.rstd[m] * n_scale[k] + n_bias[k]);
    };
    stream_split(stage, a.up.w, a.up.s, F, a.up.gs, t.n_base, t.rows, t.k_lo, t.k_hi,
                 a.ws_u + ((size_t)t.z * M + t.m0) * F, sm);
    if (gated)
      stream_split(stage, a.gate.w, a.gate.s, F, a.gate.gs, t.n_base, t.rows, t.k_lo, t.k_hi,
                   a.ws_g + ((size_t)t.z * M + t.m0) * F, sm);
    if (!arrive(&a.arr_u[t.tile], a.up.splits, sm)) continue;
    sum_splits(a.ws_u, a.up.splits, M, F, t.m0, t.n_base, t.rows, sm.fin[0]);
    if (gated) sum_splits(a.ws_g, a.up.splits, M, F, t.m0, t.n_base, t.rows, sm.fin[1]);
    for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
      const int m = i / kBlockN, col = i % kBlockN, n = t.n_base + col;
      if (m >= t.rows || n >= F) continue;
      const float u = sm.fin[0][m][col] + a.up.b[n];
      const float h = gated ? activate(sm.fin[1][m][col] + a.gate.b[n], a.act) * u
                            : activate(u, a.act);
      a.up_h[(size_t)(t.m0 + m) * F + n] = __float2bfloat16(h);
    }
  }
  prefetch_first(a.down, M, H);
  grid.sync();

  // phase 3: out = res2 + up_h @ down + down_bias
  for (int it = blockIdx.x, n_it = items_of(a.down, M, H); it < n_it; it += gridDim.x) {
    const Item t = item_of(it, a.down, M, H);
    const __nv_bfloat16* hrow = a.up_h + (size_t)t.m0 * F;
    stream_split([&](int m, int k) { return load_bf16_cg(hrow + (size_t)m * F + k); }, a.down.w,
                 a.down.s, H, a.down.gs, t.n_base, t.rows, t.k_lo, t.k_hi,
                 a.ws_d + ((size_t)t.z * M + t.m0) * H, sm);
    if (!arrive(&a.arr_d[t.tile], a.down.splits, sm)) continue;
    sum_splits(a.ws_d, a.down.splits, M, H, t.m0, t.n_base, t.rows, sm.fin[0]);
    for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
      const int m = i / kBlockN, col = i % kBlockN, n = t.n_base + col;
      if (m >= t.rows || n >= H) continue;
      const size_t at = (size_t)(t.m0 + m) * H + n;
      a.out[at] = __float2bfloat16((__ldcg(a.res2 + at) + sm.fin[0][m][col]) + a.down.b[n]);
    }
  }
}

Proj proj(const void* w, const void* s, const void* b, int K, int G, int splits, int k_per) {
  Proj p;
  p.w = static_cast<const int8_t*>(w);
  p.s = static_cast<const float*>(s);
  p.b = static_cast<const float*>(b);
  p.K = K;
  p.gs = K / G;
  p.splits = splits;
  p.k_per = k_per;
  return p;
}

}  // namespace

// The largest grid whose blocks are all co-resident on the current device:
// SMs x blocks per SM at this kernel's registers and shared memory.
DS_EXPORT int resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, out_mlp_kernel, kThreads, 0);
  *blocks = sms * per_sm;
  return static_cast<int>(e);
}

// Device pointers; the caller checked shapes, types, contiguity, H % 4 == 0,
// F % 4 == 0 and 16-byte alignment. gate pointers and ws_g are null for an
// ungated MLP. ws_o/ws_u/ws_g/ws_d hold splits x M x N floats of their phase;
// arr_o/arr_u/arr_d one zeroed int per (column, row) tile of their phase,
// left zeroed. ``blocks`` must not exceed resident_blocks(). Returns the
// launch's error code.
DS_EXPORT int out_mlp_launch(const void* attn, const void* x, const void* norms, const void* o_w,
                             const void* o_s, const void* o_b, const void* up_w, const void* up_s,
                             const void* up_b, const void* gt_w, const void* gt_s,
                             const void* gt_b, const void* dn_w, const void* dn_s,
                             const void* dn_b, void* out, void* res2, void* up_h, void* ws_o,
                             void* ws_u, void* ws_g, void* ws_d, void* arr_o, void* arr_u,
                             void* arr_d, int M, int H, int F, int Ko, int Go, int Gu, int Gd,
                             int so, int ko, int su, int ku, int sd, int kd, int act, float eps,
                             int rms, int blocks, void* stream) {
  Args a;
  a.attn = static_cast<const __nv_bfloat16*>(attn);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.norms = static_cast<const float*>(norms);
  a.o = proj(o_w, o_s, o_b, Ko, Go, so, ko);
  a.up = proj(up_w, up_s, up_b, H, Gu, su, ku);
  a.gate = proj(gt_w, gt_s, gt_b, H, Gu, su, ku);
  a.down = proj(dn_w, dn_s, dn_b, F, Gd, sd, kd);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.res2 = static_cast<float*>(res2);
  a.up_h = static_cast<__nv_bfloat16*>(up_h);
  a.ws_o = static_cast<float*>(ws_o);
  a.ws_u = static_cast<float*>(ws_u);
  a.ws_g = static_cast<float*>(ws_g);
  a.ws_d = static_cast<float*>(ws_d);
  a.arr_o = static_cast<int*>(arr_o);
  a.arr_u = static_cast<int*>(arr_u);
  a.arr_d = static_cast<int*>(arr_d);
  a.M = M;
  a.H = H;
  a.F = F;
  a.act = act;
  a.rms = rms;
  a.eps = eps;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(out_mlp_kernel),
                                              dim3(blocks), dim3(kThreads), params, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
