// Decode attention over a KV cache, for Hopper: the static engine's decode
// mode and the scheduler's paged decode and paged span modes, bf16 or int8 KV.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel
// in its decode_attention, paged_decode_attention and paged_span_attention
// modes and its int8-KV mode. Same function: the queries of a (row, kv head)
// are R folded rows, the group's query heads times T span columns with the
// column fastest (decode: T = 1, R = g), and folded row r attends the cache
// slots [start[b], ends[b] + r % T) with an fp32 online softmax; GQA-native
// (the folded rows of a group share one KV head); a row whose window is
// empty (a dead slot, ends == 0) gets l = 0, guarded to 1, so out = 0. p and
// v stay in fp32, as in the TPU kernel. With int8 KV each cache row carries
// one fp16 scale shared by K and V across heads, and the kernel dequantizes
// in registers, k * scale in fp32 as the TPU kernel does: the bf16 rows
// never exist in memory.
//
// Layout (the JAX one): q (B, Hkv, R, D) bf16; k/v cache (B, Hkv, S, D) bf16
// or int8; k/v scales (B, 1, S, 1) fp16 (int8 only); start, ends (B,) int32;
// out (B, Hkv, R, D) bf16. D is 64 or 128.
//
// What bounds it on the H100: the KV bytes inside the windows,
// sum_b (window_b) * Hkv * D * 2 * (2 bytes bf16, 1 byte int8) plus 2 bytes a
// row of scales, over 3.35 TB/s; at decode batch sizes the launch and
// per-slot latency dominate that, and at the chunk step (T = 64) the
// per-(row, key) softmax work.
//
// Design: one block per (b, kv head, group of 8 folded rows), 8 warps. The
// TPU kernel folded every (b, kv head) into one batched dot and walked KV
// blocks along a sequential grid axis up to max(ends); here each block walks
// only its own rows' windows, so nothing past them (or before start[b]) is
// read and the scheduler needs no max(ends) on the host. Warp w takes cache
// slots start + w, start + w + 8, ...; its 32 lanes split D (2 or 4
// contiguous elements each, so a slot's K row is one coalesced read), reduce
// each row's dot with shuffles and keep a running (max, sum, acc) per row.
// The 8 warps' partial softmax states merge in shared memory in a fixed
// order, so the result is the same on every run. One code path serves both
// modes: a row's arithmetic depends only on its own window, so span column c
// of a row computes bitwise what the decode mode computes for a row with
// the same window. The scheduler's results then do not depend on whether a
// token rode a chunk step or a decode step (its K-invariance on the card).
// A span re-reads the window once per group of 8 folded rows (from L2);
// tensor-core tiles for long spans are later work.

#include <math.h>

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGmax = 8;  // folded query rows per block

// Dl contiguous K or V elements of one cache row as fp32, times the row's
// dequantization scale (int8) or as they are (bf16).
template <int Dl>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float, float* f) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < Dl / 2; ++i) {
    const float2 x = __bfloat1622float2(p2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int Dl>
__device__ __forceinline__ void load_row(const int8_t* p, float s, float* f) {
#pragma unroll
  for (int i = 0; i < Dl; ++i) f[i] = static_cast<float>(p[i]) * s;
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kc,
              const KV* __restrict__ vc, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ start,
              const int* __restrict__ ends, __nv_bfloat16* __restrict__ out, int nkv, int R,
              int T, int S, float scale) {
  constexpr int Dl = D / 32;  // contiguous elements per lane
  constexpr bool kQuant = sizeof(KV) == 1;
  __shared__ float sm_m[kWarps][kGmax];
  __shared__ float sm_l[kWarps][kGmax];
  __shared__ float sm_acc[kWarps][kGmax][D];

  const int groups = (R + kGmax - 1) / kGmax;
  const int bh = blockIdx.x / groups, r0 = (blockIdx.x % groups) * kGmax;
  const int b = bh / nkv;
  const int g = min(kGmax, R - r0);  // folded rows of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = max(start[b], 0);
  int hi_r[kGmax];  // each row's exclusive window end
  int hi = lo;
#pragma unroll
  for (int h = 0; h < kGmax; ++h) {
    hi_r[h] = h < g ? min(ends[b] + (r0 + h) % T, S) : 0;
    hi = max(hi, hi_r[h]);
  }

  const __nv_bfloat16* qb = q + ((size_t)bh * R + r0) * D;
  float qr[kGmax][Dl];
#pragma unroll
  for (int h = 0; h < kGmax; ++h)
#pragma unroll
    for (int i = 0; i < Dl; ++i)
      qr[h][i] = h < g ? __bfloat162float(qb[h * D + lane * Dl + i]) * scale : 0.f;

  float m[kGmax], l[kGmax], acc[kGmax][Dl];
#pragma unroll
  for (int h = 0; h < kGmax; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < Dl; ++i) acc[h][i] = 0.f;
  }

  const size_t base = (size_t)bh * S * D;
  for (int pos = lo + warp; pos < hi; pos += kWarps) {
    const float ksc = kQuant ? __half2float(ks[(size_t)b * S + pos]) : 1.f;
    const float vsc = kQuant ? __half2float(vs[(size_t)b * S + pos]) : 1.f;
    float kf[Dl], vf[Dl];
    load_row<Dl>(kc + base + (size_t)pos * D + lane * Dl, ksc, kf);
    load_row<Dl>(vc + base + (size_t)pos * D + lane * Dl, vsc, vf);
#pragma unroll
    for (int h = 0; h < kGmax; ++h) {
      if (pos < hi_r[h]) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < Dl; ++i) dot = fmaf(qr[h][i], kf[i], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float m_new = fmaxf(m[h], dot);
        const float alpha = expf(m[h] - m_new);
        const float p = expf(dot - m_new);
        l[h] = l[h] * alpha + p;
#pragma unroll
        for (int i = 0; i < Dl; ++i) acc[h][i] = acc[h][i] * alpha + p * vf[i];
        m[h] = m_new;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < kGmax; ++h) {
    if (h < g) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
#pragma unroll
      for (int i = 0; i < Dl; ++i) sm_acc[warp][h][lane * Dl + i] = acc[h][i];
    }
  }
  __syncthreads();

  __nv_bfloat16* ob = out + ((size_t)bh * R + r0) * D;
  for (int i = threadIdx.x; i < g * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][h]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // fixed merge order
      const float f = sm_m[w][h] == -INFINITY ? 0.f : expf(sm_m[w][h] - mm);
      L += sm_l[w][h] * f;
      A += sm_acc[w][h][d] * f;
    }
    ob[h * D + d] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* start, const void* ends, void* out, int B, int nkv, int R, int T, int S,
           int D, float scale, cudaStream_t s) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const __half*>(ks);
  const auto* vsp = static_cast<const __half*>(vs);
  const auto* sp = static_cast<const int*>(start);
  const auto* ep = static_cast<const int*>(ends);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int blocks = B * nkv * ((R + kGmax - 1) / kGmax);
  if (D == 64) {
    decode_kernel<64, KV><<<blocks, kThreads, 0, s>>>(qp, kp, vp, ksp, vsp, sp, ep, op, nkv, R, T,
                                                      S, scale);
  } else if (D == 128) {
    decode_kernel<128, KV><<<blocks, kThreads, 0, s>>>(qp, kp, vp, ksp, vsp, sp, ep, op, nkv, R,
                                                       T, S, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity and D in
// {64, 128}. q/out hold R folded rows per (row, kv head), T span columns
// with the column fastest (T = 1 in the decode modes). ``quant``: int8 K/V
// with (B, S) fp16 row scales ks/vs (null otherwise). Returns
// cudaGetLastError().
DS_EXPORT int decode_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* start,
                            const void* ends, void* out, int B, int nkv, int R, int T, int S,
                            int D, int quant, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, start, ends, out, B, nkv, R, T,
                          S, D, scale, s);
  return launch<__nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, start, ends, out, B, nkv,
                               R, T, S, D, scale, s);
}
