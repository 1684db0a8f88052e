// Decode attention over a KV cache, for Hopper: the static engine's decode
// mode, the scheduler's paged decode and paged span modes and their extent
// modes (long-context KV chains, lossy sliding windows), bf16 or int8 KV.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel
// (its decode_attention, paged_decode_attention and paged_span_attention
// modes and its int8-KV mode) and ::_extent_kernel (extent_paged_decode_attention,
// extent_paged_span_attention). Same function: the queries of a (row, kv
// head) are R folded rows, the group's query heads times T span columns
// with the column fastest (decode: T = 1, R = g), and folded row r attends
// the LOGICAL positions [start[b], ends[b] + r % T) with an fp32 online
// softmax; GQA-native (the folded rows of a group share one KV head); a row
// whose window is empty (a dead slot, ends == 0) gets l = 0, guarded to 1,
// so out = 0. p and v stay in fp32, as in the TPU kernels. With int8 KV each
// cache row carries one fp16 scale shared by K and V across heads, and the
// kernel dequantizes in registers, k * scale in fp32 as the TPU kernel
// does: the bf16 rows never exist in memory.
//
// Extent modes: an extent table ext (B, E) int32 maps row b's logical
// extent e (positions [e*S, (e+1)*S)) to a pool row, -1 where the extent
// was dropped; logical position p lives at pool row max(ext[b, p / S], 0),
// offset p % S. Windows reach E*S. A row with win[b] > 0 (the lossy
// StreamingLLM mode) also skips the positions in [sink[b], end_r - win[b]),
// end_r its folded row's own end. Without a table the pool row is b and
// E = 1: the paged modes, with their exact arithmetic.
//
// Layout (the JAX one): q (B, Hkv, R, D) bf16; k/v cache (Np, Hkv, S, D)
// bf16 or int8 (Np = B without a table); k/v scales (Np, 1, S, 1) fp16
// (int8 only); start, ends, sink, win (B,) int32; out (B, Hkv, R, D) bf16.
// D is 64 or 128.
//
// What bounds it on the H100: the KV bytes inside the kept windows,
// sum_b (window_b) * Hkv * D * 2 * (2 bytes bf16, 1 byte int8) plus 2 bytes a
// row of scales, over 3.35 TB/s; at decode batch sizes the launch and
// per-slot latency dominate that, and at the chunk step (T = 64) the
// per-(row, key) softmax work.
//
// Design: one block per (b, kv head, group of 8 folded rows), 8 warps. The
// TPU kernels folded every (b, kv head) into one batched dot and walked KV
// blocks along a sequential grid axis up to max(ends) (the extent kernel
// streamed the whole pool column at each logical block and gathered each
// row's extent in registers); here each block walks only its own rows'
// windows, so nothing past them (or before start[b]) is read and the
// scheduler needs no max(ends) on the host. Warp w takes logical positions
// start + w, start + w + 8, ...; only the address of a position depends on
// the table. Its 32 lanes split D (2 or 4 contiguous elements each, so a
// position's K row is one coalesced read), reduce each row's dot with
// shuffles and keep a running (max, sum, acc) per row. A position that no
// row of the block keeps is not loaded, and the walk jumps the lossy hole
// that all its rows share: a dropped extent (whose pool row may by now
// hold another request's KV) is never read. The 8 warps' partial softmax
// states merge in shared memory in a fixed order, so the result is the same
// on every run. One code path serves every mode: a row's arithmetic depends
// only on its own logical window, so span column c of a row computes
// bitwise what the decode mode computes for a row with the same window (the
// scheduler's results do not depend on whether a token rode a chunk step or
// a decode step), a chained row bitwise what one slot of E*S rows holding
// the same window computes, and an identity table what the paged modes
// compute. A span re-reads the window once per group of 8 folded rows (from
// L2); tensor-core tiles for long spans are later work.

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

// kExt: the extent modes (a table, logical windows to E * S, the lossy
// mask). The paged modes instantiate it false, so their code is the plain
// walk of one row's slot; a position's arithmetic is the same in both.
template <int D, typename KV, bool kExt>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kc,
              const KV* __restrict__ vc, const __half* __restrict__ ks,
              const __half* __restrict__ vs, const int* __restrict__ start,
              const int* __restrict__ ends, const int* __restrict__ ext,
              const int* __restrict__ sink, const int* __restrict__ win,
              __nv_bfloat16* __restrict__ out, int nkv, int R, int T, int S, int E, float scale) {
  constexpr int Dl = D / 32;  // contiguous elements per lane
  constexpr bool kQuant = sizeof(KV) == 1;
  __shared__ float sm_m[kWarps][kGmax];
  __shared__ float sm_l[kWarps][kGmax];
  __shared__ float sm_acc[kWarps][kGmax][D];

  const int groups = (R + kGmax - 1) / kGmax;
  const int bh = blockIdx.x / groups, r0 = (blockIdx.x % groups) * kGmax;
  const int b = bh / nkv, h_kv = bh % nkv;
  const int g = min(kGmax, R - r0);  // folded rows of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = max(start[b], 0);
  const int cap = kExt ? E * S : S;  // the logical window's end
  const int sk = kExt && sink ? sink[b] : 0;
  const int wn = kExt && win ? win[b] : 0;
  int hi_r[kGmax];  // each row's exclusive window end
  int keep_r[kGmax];  // each row keeps [lo, sk) and [keep_r, hi_r)
  int hi = lo, hole_hi = cap;
#pragma unroll
  for (int h = 0; h < kGmax; ++h) {
    const int end = ends[b] + (r0 + h) % T;
    hi_r[h] = h < g ? min(end, cap) : 0;
    keep_r[h] = wn > 0 ? end - wn : lo;
    hi = max(hi, hi_r[h]);
    if (h < g) hole_hi = min(hole_hi, keep_r[h]);
  }
  // the lossy hole every row of the block skips: [sk, hole_hi)
  const int hole_lo = wn > 0 ? sk : cap;

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

  for (int pos = lo + warp; pos < hi; pos += kWarps) {
    int prow = b, off = pos;  // the pool row and offset holding logical pos
    if constexpr (kExt) {
      if (pos >= hole_lo && pos < hole_hi) {  // jump to this warp's first position past the hole
        pos += (hole_hi - pos + kWarps - 1) / kWarps * kWarps - kWarps;
        continue;
      }
      bool need = false;
#pragma unroll
      for (int h = 0; h < kGmax; ++h) need |= pos < hi_r[h] && (pos < sk || pos >= keep_r[h]);
      if (!need) continue;
      const int e = pos / S;
      off = pos - e * S;
      prow = max(ext[(size_t)b * E + e], 0);
    }
    const float ksc = kQuant ? __half2float(ks[(size_t)prow * S + off]) : 1.f;
    const float vsc = kQuant ? __half2float(vs[(size_t)prow * S + off]) : 1.f;
    const size_t row = (((size_t)prow * nkv + h_kv) * S + off) * D + lane * Dl;
    float kf[Dl], vf[Dl];
    load_row<Dl>(kc + row, ksc, kf);
    load_row<Dl>(vc + row, vsc, vf);
#pragma unroll
    for (int h = 0; h < kGmax; ++h) {
      if (pos < hi_r[h] && (!kExt || pos < sk || pos >= keep_r[h])) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < Dl; ++i) dot = fmaf(qr[h][i], kf[i], dot);
#pragma unroll
        for (int off2 = 16; off2 > 0; off2 >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off2);
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
           const void* start, const void* ends, const void* ext, const void* sink, const void* win,
           void* out, int B, int nkv, int R, int T, int S, int E, int D, float scale,
           cudaStream_t s) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const __half*>(ks);
  const auto* vsp = static_cast<const __half*>(vs);
  const auto* sp = static_cast<const int*>(start);
  const auto* ep = static_cast<const int*>(ends);
  const auto* xp = static_cast<const int*>(ext);
  const auto* skp = static_cast<const int*>(sink);
  const auto* wp = static_cast<const int*>(win);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int blocks = B * nkv * ((R + kGmax - 1) / kGmax);
#define DS_DECODE(Dv, X)                                                                         \
  decode_kernel<Dv, KV, X><<<blocks, kThreads, 0, s>>>(qp, kp, vp, ksp, vsp, sp, ep, xp, skp, wp, \
                                                       op, nkv, R, T, S, E, scale)
  if (D == 64) {
    if (xp) DS_DECODE(64, true); else DS_DECODE(64, false);
  } else if (D == 128) {
    if (xp) DS_DECODE(128, true); else DS_DECODE(128, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_DECODE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity and D in
// {64, 128}. q/out hold R folded rows per (row, kv head), T span columns
// with the column fastest (T = 1 in the decode modes). ``quant``: int8 K/V
// with (Np, S) fp16 row scales ks/vs (null otherwise). ``ext``: the (B, E)
// extent table of the extent modes, or null (the pool row of row b is b,
// E = 1); ``sink``/``win``: (B,) lossy-window bounds, or null (none).
// Returns cudaGetLastError().
DS_EXPORT int decode_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* start,
                            const void* ends, const void* ext, const void* sink, const void* win,
                            void* out, int B, int nkv, int R, int T, int S, int E, int D,
                            int quant, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, start, ends, ext, sink, win, out,
                          B, nkv, R, T, S, E, D, scale, s);
  return launch<__nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, start, ends, ext, sink, win,
                               out, B, nkv, R, T, S, E, D, scale, s);
}
