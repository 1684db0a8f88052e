// Single-token decode attention over a contiguous KV cache, for Hopper.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel
// in its decode_attention mode (bf16 KV, one query per row). Same function:
// each query row attends the cache slots [start[b], ends[b]) with an fp32
// online softmax; GQA-native (the g query heads of a group share one KV
// head); a row whose window is empty gets l = 0, guarded to 1, so out = 0.
//
// Layout (the JAX one): q (B, H, D) bf16; k/v cache (B, Hkv, S, D) bf16;
// start, ends (B,) int32; out (B, H, D) bf16. D is 64 or 128, g <= 8.
//
// What bounds it on the H100: the KV bytes inside the windows,
// sum_b (ends[b] - start[b]) * Hkv * D * 2 * 2, over 3.35 TB/s; at decode
// batch sizes the launch and per-slot latency dominate that.
//
// Design: one block per (b, kv head), 8 warps. The TPU kernel folded every
// (b, kv head) into one batched dot and walked KV blocks along a sequential
// grid axis, skipping blocks past max(end); here each block walks only its
// own row's window, so nothing past ends[b] (or before start[b]) is read.
// Warp w takes cache slots start + w, start + w + 8, ...; its 32 lanes split
// D (2 or 4 contiguous bf16 each, so a slot's K row is one coalesced read),
// reduce each head's dot with shuffles and keep a running (max, sum, acc)
// per head. The 8 warps' partial softmax states merge in shared memory in a
// fixed order, so the result is the same on every run.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGmax = 8;  // query heads per KV head

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
              const __nv_bfloat16* __restrict__ vc, const int* __restrict__ start,
              const int* __restrict__ ends, __nv_bfloat16* __restrict__ out, int nkv, int g,
              int S, float scale) {
  constexpr int Dl = D / 32;  // contiguous elements per lane
  __shared__ float sm_m[kWarps][kGmax];
  __shared__ float sm_l[kWarps][kGmax];
  __shared__ float sm_acc[kWarps][kGmax][D];

  const int b = blockIdx.x / nkv, kvh = blockIdx.x % nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = max(start[b], 0), hi = min(ends[b], S);

  const __nv_bfloat16* qb = q + ((size_t)b * nkv * g + (size_t)kvh * g) * D;
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

  const size_t base = (size_t)(b * nkv + kvh) * S * D;
  for (int pos = lo + warp; pos < hi; pos += kWarps) {
    const __nv_bfloat162* kr =
        reinterpret_cast<const __nv_bfloat162*>(kc + base + (size_t)pos * D + lane * Dl);
    const __nv_bfloat162* vr =
        reinterpret_cast<const __nv_bfloat162*>(vc + base + (size_t)pos * D + lane * Dl);
    float kf[Dl], vf[Dl];
#pragma unroll
    for (int i = 0; i < Dl / 2; ++i) {
      const float2 k2 = __bfloat1622float2(kr[i]);
      const float2 v2 = __bfloat1622float2(vr[i]);
      kf[2 * i] = k2.x;
      kf[2 * i + 1] = k2.y;
      vf[2 * i] = v2.x;
      vf[2 * i + 1] = v2.y;
    }
#pragma unroll
    for (int h = 0; h < kGmax; ++h) {
      if (h < g) {
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

  __nv_bfloat16* ob = out + ((size_t)b * nkv * g + (size_t)kvh * g) * D;
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

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, D in
// {64, 128} and g = H / nkv <= 8. Returns cudaGetLastError().
DS_EXPORT int decode_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* start, const void* ends, void* out, int B, int nkv,
                            int g, int S, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_cache);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_cache);
  const auto* sp = static_cast<const int*>(start);
  const auto* ep = static_cast<const int*>(ends);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64) {
    decode_kernel<64><<<B * nkv, kThreads, 0, s>>>(qp, kp, vp, sp, ep, op, nkv, g, S, scale);
  } else if (D == 128) {
    decode_kernel<128><<<B * nkv, kThreads, 0, s>>>(qp, kp, vp, sp, ep, op, nkv, g, S, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
