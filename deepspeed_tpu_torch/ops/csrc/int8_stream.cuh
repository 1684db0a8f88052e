// int8 weight streaming shared by the fused decode-layer kernels
// (fused_qkv_ln.cu, fused_out_mlp.cu).
//
// A work item is one block's share of an int8 matmul at decode batch: 8 rows
// of activations against the weight rows [k_lo, k_hi) of one 128-column
// tile. Weights arrive 128 rows (16 KB) at a time through a two-slot
// shared-memory ring filled by cp.async, eight 16-byte copies to a 128-byte
// row segment, so the next chunk is in flight while this one is used. The
// compute tiling is quant_matmul.cu's: 8 warps are 8 slices of K, a warp's
// 32 lanes take 4 adjacent columns each, and the accumulators of all 8
// activation rows stay in registers, so every int8 byte feeds 8
// multiply-adds. Activations are staged 128 K-rows at a time through a
// caller-supplied functor, which is where a kernel folds in a norm (and the
// cast to the compute dtype) without writing the normalized rows anywhere.
// Each quantization group's fp32 partial is multiplied by its scale row, and
// the 8 slices are summed in shared memory in a fixed order.
//
// A split writes its fp32 partial to a workspace; the last block of a tile
// to arrive (an integer counter, no float atomics) sums the splits in split
// order, so results do not depend on arrival order or on the run.

#pragma once

#include "common.cuh"

namespace int8s {

constexpr int kThreads = 256;
constexpr int kRows = 8;                  // activation rows per work item
constexpr int kCols = 4;                  // adjacent columns per thread
constexpr int kTx = 32;                   // threads across N
constexpr int kBlockN = kTx * kCols;      // 128 columns per tile
constexpr int kSlices = kThreads / kTx;   // K slices per block (one per warp)
constexpr int kChunk = 128;               // K rows staged per pass
constexpr int kStages = 2;                // weight chunks in the shared-memory ring
constexpr int kIters = kChunk / kSlices;  // weight rows per thread per pass

// Both kernels ask for two blocks an SM (at most 128 registers a thread):
// the stream is bound by the loads in flight, and a second block an SM
// carried more of them than the registers it gives up (kernel C spills a
// little at 128; at one block an SM it was slower all the same)
constexpr int kMinBlocks = 2;

// Shared memory of both kernels (45 KB). The weight ring is free once a
// work item's chunks are consumed, so the slice reduction reuses it.
struct Smem {
  union {
    int8_t w[kStages][kChunk][kBlockN];      // weight chunks in flight
    float red[kSlices][kRows][kBlockN + 1];  // per-slice partial sums
  } u;
  float xs[kRows][kChunk];
  float fin[2][kRows][kBlockN];  // a tile's summed splits (two matrices: up and gate)
  float mu[kRows];
  float rstd[kRows];
  int last;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp: the norm statistics of a row of H values (H % 4 == 0), as the
// JAX kernels' _norm takes them. layernorm: mu = mean(x), var = mean((x -
// mu)^2), two passes; rmsnorm: mu = 0, var = mean(x^2). load4(j) returns
// values 4j .. 4j+3. Each lane keeps kStatLoads loads in flight (the row sits
// in L2, so a pass is a few load latencies, not H/32 of them). Lane 0 writes
// mu and 1/sqrt(var + eps).
constexpr int kStatLoads = 8;

template <typename Load4, typename F>
__device__ __forceinline__ float warp_row_sum(const Load4& load4, int n4, const F& f) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int j0 = 0; j0 < n4; j0 += 32 * kStatLoads) {
    float4 v[kStatLoads];
#pragma unroll
    for (int u = 0; u < kStatLoads; ++u) {
      const int j = j0 + u * 32 + lane;
      v[u] = j < n4 ? load4(j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kStatLoads; ++u)
      if (j0 + u * 32 + lane < n4) s += (f(v[u].x) + f(v[u].y)) + (f(v[u].z) + f(v[u].w));
  }
  return warp_sum(s);
}

template <typename Load4>
__device__ __forceinline__ void warp_row_stats(const Load4& load4, int H, float eps, bool rms,
                                               float* mu_out, float* rstd_out) {
  const int n4 = H / 4;
  const float mu = rms ? 0.f : warp_row_sum(load4, n4, [](float v) { return v; }) / H;
  const float var = warp_row_sum(load4, n4, [mu](float v) { return (v - mu) * (v - mu); }) / H;
  if (threadIdx.x % 32 == 0) {
    *mu_out = mu;
    *rstd_out = 1.f / sqrtf(var + eps);
  }
}

// Asynchronous copies into shared memory (cp.async): the loads hold no
// registers while in flight, so the next chunk of weights (16 KB a block)
// is on the way while the block stages and multiplies this one.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Start copying weight rows [k0, k0 + kc) of the 128-column tile at n_base
// into a ring slot, row r at slot[r]. Columns past N are zero-filled (16-byte
// copies) or left stale (4-byte copies); either way they only feed columns
// no thread writes. Rows past kc are left stale: their activations are 0.
__device__ __forceinline__ void copy_chunk(int8_t (*slot)[kBlockN], const int8_t* __restrict__ w,
                                           int N, int n_base, int k0, int kc) {
  if (N % 16 == 0) {  // 16-byte copies: eight per 128-byte row
    for (int i = threadIdx.x; i < kc * 8; i += kThreads) {
      const int r = i / 8, c = (i % 8) * 16;
      const int valid = min(16, N - (n_base + c));
      if (valid > 0) cp_async16(&slot[r][c], w + (size_t)(k0 + r) * N + n_base + c, valid);
    }
  } else {  // rows not 16-byte aligned: 4-byte copies (N % 4 == 0)
    for (int i = threadIdx.x; i < kc * 32; i += kThreads) {
      const int r = i / 32, c = (i % 32) * 4;
      if (n_base + c < N) cp_async4(&slot[r][c], w + (size_t)(k0 + r) * N + n_base + c);
    }
  }
}

// Ask L2 for weight rows [r0, r1) of the 128-column tile at n_base: one
// 128-byte line a row, no registers held, so the DRAM stream runs ahead of
// the loads that wait for it.
__device__ __forceinline__ void prefetch_rows(const int8_t* w, int N, int n_base, int r0, int r1) {
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(w + (size_t)r * N + n_base));
}

// End of the chunk that starts at k0: kChunk rows, cut at the end of k0's
// quantization group and at k_hi, so a chunk never spans two groups.
__device__ __forceinline__ int chunk_end(int k0, int gs, int k_hi) {
  return min(min(k0 + kChunk, (k0 / gs + 1) * gs), k_hi);
}

// One work item: ``rows`` activation rows, produced by stage(m, k) (m < rows,
// k the contraction index), against weight rows [k_lo, k_hi) of the
// 128-column tile at n_base of w (K, N) int8 with scales (G, N) fp32 (group
// size gs). Writes the fp32 partial to part[m * N + n].
//
// The chunks stream through a ring of kStages slots: kStages - 1 are in
// flight while the block stages and multiplies the oldest; a slot is
// refilled once every thread is past the chunk it held. The activations are
// staged before the wait, so their loads overlap the weights'.
template <typename Stage>
__device__ __forceinline__ void stream_split(const Stage& stage, const int8_t* __restrict__ w,
                                             const float* __restrict__ scales, int N, int gs,
                                             int n_base, int rows, int k_lo, int k_hi,
                                             float* __restrict__ part, Smem& sm) {
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int n0 = n_base + tx * kCols;
  const bool live = n0 < N;  // N % 4 == 0: a thread's 4 columns are all in or all out

  float acc[kRows][kCols], p[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = p[m][c] = 0.f;

  __syncthreads();  // the previous item's readers are done with the ring (and red)
  int k_issue = k_lo;
  auto issue = [&](int slot) {  // the next chunk, if any, into ``slot``; one group either way
    if (k_issue < k_hi) {
      const int k_next = chunk_end(k_issue, gs, k_hi);
      copy_chunk(sm.u.w[slot], w, N, n_base, k_issue, k_next - k_issue);
      k_issue = k_next;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  for (int k0 = k_lo, c = 0; k0 < k_hi; ++c) {
    const int k1 = chunk_end(k0, gs, k_hi), kc = k1 - k0;
    const float4 s = live ? __ldg(reinterpret_cast<const float4*>(scales + (size_t)(k0 / gs) * N + n0))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // chunk c - 1's readers are done with its slot and with xs
    issue((c + kStages - 1) % kStages);  // chunk c - 1's slot
    // the activations' loads overlap the weights still in flight
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int m = i / kChunk, kk = i % kChunk;
      sm.xs[m][kk] = (m < rows && kk < kc) ? stage(m, k0 + kk) : 0.f;
    }
    cp_async_wait<kStages - 1>();  // this thread's copies of chunk c have landed
    __syncthreads();               // everyone's have, and xs is staged
    const int8_t(*slot)[kBlockN] = sm.u.w[c % kStages];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int kk = ty + it * kSlices;  // rows past kc meet zero activations
      const char4 wv = *reinterpret_cast<const char4*>(&slot[kk][tx * kCols]);
      const float wf[kCols] = {static_cast<float>(wv.x), static_cast<float>(wv.y),
                               static_cast<float>(wv.z), static_cast<float>(wv.w)};
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float xv = sm.xs[m][kk];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) p[m][cc] = fmaf(xv, wf[cc], p[m][cc]);
      }
    }
    if (k1 == k_hi || k1 % gs == 0) {  // k0's group ends with this chunk: the
      // group's scale distributes over the partial sums of its rows
      const float sv[kCols] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc[m][cc] += p[m][cc] * sv[cc];
          p[m][cc] = 0.f;
        }
    }
    k0 = k1;
  }
  cp_async_wait<0>();  // only empty groups can still be open
  __syncthreads();     // the ring's last readers are done: red reuses its memory

#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) sm.u.red[ty][m][tx * kCols + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = n_base + col;
    if (m < rows && n < N) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kSlices; ++k) s += sm.u.red[k][m][col];  // fixed order
      part[(size_t)m * N + n] = s;
    }
  }
}

// Count this block's split of a tile in. True in the one block that arrives
// last; that block also re-zeroes the counter for the next launch.
__device__ __forceinline__ bool arrive(int* counter, int expected, Smem& sm) {
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;  // every split has arrived
    sm.last = last;
  }
  __syncthreads();
  const bool last = sm.last;
  if (last) __threadfence();
  return last;
}

// The last block of a tile: fin[m][col] = the tile's splits summed in split
// order (ws holds ``splits`` partials of (M, N), the tile's rows from m0).
__device__ __forceinline__ void sum_splits(const float* ws, int splits, int M, int N, int m0,
                                           int n_base, int rows, float (*fin)[kBlockN]) {
  for (int i = threadIdx.x; i < kRows * kBlockN; i += kThreads) {
    const int m = i / kBlockN, col = i % kBlockN;
    const int n = n_base + col;
    float s = 0.f;
    if (m < rows && n < N) {
      const float* p = ws + (size_t)(m0 + m) * N + n;
      const size_t stride = (size_t)M * N;
      int z = 0;
      for (; z + 8 <= splits; z += 8) {  // eight loads in flight, summed in split order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + (z + u) * stride);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
      }
      for (; z < splits; ++z) s += __ldcg(p + z * stride);
    }
    fin[m][col] = s;
  }
  __syncthreads();
}

}  // namespace int8s
