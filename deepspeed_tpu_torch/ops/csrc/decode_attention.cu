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
// whose window is empty (a dead slot, ends == 0) gets exact zeros. With int8
// KV each cache row carries one fp16 scale shared by K and V across heads.
//
// Extent modes: an extent table ext (B, E) int32 maps row b's logical
// extent e (positions [e*S, (e+1)*S)) to a pool row, -1 where the extent
// was dropped; logical position p lives at pool row max(ext[b, p / S], 0),
// offset p % S. Windows reach E*S. A row with win[b] > 0 (the lossy
// StreamingLLM mode) also skips the positions in [sink[b], end_r - win[b]),
// end_r its folded row's own end. Without a table the pool row is b and
// E = 1: the paged modes.
//
// Layout (the JAX one): q (B, Hkv, R, D) bf16; k/v cache (Np, Hkv, S, D)
// bf16 or int8 (Np = B without a table); k/v scales (Np, 1, S, 1) fp16
// (int8 only); start, ends, sink, win (B,) int32; out (B, Hkv, R, D) bf16.
// D is 64 or 128.
//
// What bounds it on the H100: the KV bytes inside the kept windows,
// sum_b (window_b) * Hkv * D * 2 * (2 bytes bf16, 1 byte int8) plus 2 bytes a
// position of scales, over 3.35 TB/s; at the chunk step (T = 64, up to 256
// folded rows a (row, kv head)) also the 4 * D tensor-core operations per
// (folded row, kept key), and at small batches the latency of a window's
// walk.
//
// Design (flash-decoding on mma.sync m16n8k16, bf16 -> fp32):
// - A CTA takes 16 folded rows (one m16 tile; R <= 16, the decode modes) or
//   64 (four tiles; R > 16, the span modes) of one (row, kv head) and one
//   CHUNK of kChunk = 512 logical positions, aligned to position 0; the
//   grid is B * Hkv * ceil(R / rows) * ceil(E*S / 512), sized from shapes alone
//   (no host read of ends), and a CTA whose rows keep nothing in its chunk
//   exits at once. Inside the chunk, TILES of kTile = 64 positions, aligned
//   to 0, stream through a 3-stage cp.async ring in shared memory; each
//   position's address comes from the table (or the row's own slot) one by
//   one, so a tile may straddle an extent boundary and S need not be a
//   multiple of the tile. A tile that no row of the CTA keeps is not loaded.
//   (One TMA bulk copy a position row was slower: 128 small copies a tile
//   queue in the TMA unit.)
// - Scores: S = Q K^T on the tensor cores (bf16 q and k; int8 values are
//   exact in bf16, widened in shared memory), then the scale (and on the
//   int8 tier each position's K scale) multiplies the fp32 scores; the
//   online softmax takes the row max and sum by one fixed shuffle tree. A
//   row's kept positions in a tile are a 64-bit mask built from its two
//   kept intervals (no branches), and 2^x is one ex2.approx.ftz.
//   With 64 rows each warp owns a row tile over the whole tile of keys;
//   with 16, warp w takes positions [16w, 16w + 16) through the scores and
//   the softmax, and the four warps exchange the row max, their 16-position
//   group sums and their P fragments through shared memory. Both layouts
//   take a row's max, exponentials, sum tree ((g0 + g1) + (g2 + g3), then
//   the lane-quad shuffles) and fragments in the same order.
// - P V: p (times each position's V scale on the int8 tier) is split into a
//   bf16 high part and a bf16 low part, two mma.sync into one fp32
//   accumulator, so p keeps about 16 bits as the TPU kernels' fp32 p does.
//   With 16 rows warp w owns output columns [w D/4, (w+1) D/4).
// - The split: a row whose kept positions lie in one chunk is written by
//   that chunk's CTA (acc / l); a row over several chunks has each chunk's
//   (m, l, acc) in a workspace, merged by a second launch in chunk order by
//   a fixed formula; chunks in which the row keeps nothing are skipped (the
//   merge reads only chunks the row's window arithmetic says it keeps).
//   With E*S <= 512 there is no second launch and no workspace.
//
// Why the invariants hold. A folded row's bits depend only on its own
// logical window: the chunk and tile constants are fixed (never functions of
// S, B, T, E or the window); tiles are walked in logical order; a score's
// products and sums and the softmax updates are the same instructions
// whatever the other rows of the CTA are (mma.sync computes an output element
// from its own row of A alone), and a tile in which the row keeps nothing is
// an exact no-op for it (alpha = 1 and p = 0, guarded even while m is still
// -inf, so l and acc keep their values). So span column c computes bitwise
// what the decode mode computes for a row with the same window (a token's
// result does not depend on whether it rode a chunk step or a decode step),
// a chained row what one slot of E*S rows holding the same window computes,
// and an identity table what the paged modes compute; the merge order is
// fixed and no value goes through an atomic, so two calls agree bit for bit.
//
// Bytes outside the windows cannot leak: a position that no row of the CTA
// keeps (past the ends, before start, in a lossy hole, in a dropped
// extent's pool row, past the cache) is never read: cp.async fills its K
// and V rows with zeros and its scales are 0, so its score is finite and
// masked and its p = 0 multiplies zeros, not NaN. A position that
// another row of the CTA keeps is read for every row of the CTA (its p is 0
// for the rows that do not keep it), so it must be finite, as written or
// zero-filled cache rows are.

#include <math.h>

#include <cuda_fp16.h>

#include "int8_mma.cuh"

namespace {

using ds_mma::bf16;

constexpr int kMergeThreads = 128;  // the merge: a warp a row
constexpr int kRows = 16;      // folded query rows a CTA: one m16 tile
constexpr int kTile = 64;      // positions a tile
constexpr int kChunk = 512;    // positions a CTA
constexpr int kStages = 3;     // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;

// bit k set for each position p0 + k (k < 64) in [x0, x1)
__device__ __forceinline__ uint64_t interval_bits(int x0, int x1, int p0) {
  const int a = min(max(x0 - p0, 0), 64), b = min(max(x1 - p0, 0), 64);
  const uint64_t below_b = b >= 64 ? ~0ull : (1ull << b) - 1;
  const uint64_t below_a = a >= 64 ? ~0ull : (1ull << a) - 1;
  return below_b & ~below_a;
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A folded row's kept logical positions: [lo, a_hi) and [b_lo, hi).
struct Win {
  int lo, a_hi, b_lo, hi;
  __device__ __forceinline__ bool keeps(int p) const {  // no branches: & and |, not && and ||
    return (p >= lo) & (p < hi) & ((p < a_hi) | (p >= b_lo));
  }
  __device__ __forceinline__ uint64_t bits(int p0) const {  // the kept positions of a tile
    return interval_bits(lo, a_hi, p0) | interval_bits(b_lo, hi, p0);
  }
  __device__ __forceinline__ bool any_in(int x0, int x1) const {
    return max(lo, x0) < min(a_hi, x1) || max(b_lo, x0) < min(hi, x1);
  }
  __device__ __forceinline__ int first() const {  // -1: keeps nothing
    return lo < a_hi ? lo : (b_lo < hi ? b_lo : -1);
  }
  __device__ __forceinline__ int last() const {
    return b_lo < hi ? hi - 1 : (lo < a_hi ? a_hi - 1 : -1);
  }
};

// The window [lo, min(end, cap)), less [sk, end - wn) where wn > 0.
__device__ __forceinline__ Win row_win(int lo, int cap, int end, int sk, int wn) {
  Win w;
  w.lo = lo;
  w.hi = min(end, cap);
  w.a_hi = wn > 0 ? min(sk, w.hi) : w.hi;
  w.b_lo = wn > 0 ? max(lo, end - wn) : w.hi;
  return w;
}

// Shared memory, byte offsets: the ring of K and V tiles (bf16 rows of
// stride D + 8, or int8 rows of D bytes widened into one bf16 pair; the q
// tile is staged in one of them before the walk), the exchange buffers
// (when warps share a row tile), the rows' windows, and the chunk's row
// indices, needed-position bits and (int8) fp32 scales.
template <int D, bool kQuant, int kRT, int kWP>
struct Smem {
  static constexpr int kLd = D + 8;
  static constexpr int kTileBf = kTile * kLd * 2;
  static constexpr int kRaw = kQuant ? kTile * D : kTileBf;  // one staged K or V tile
  static constexpr int conv = kStages * 2 * kRaw;
  static constexpr int scores = conv + (kQuant ? 2 * kTileBf : 0);
  // (kWP > 1) each warp's row max (16 a warp), 16-position group sums (4 a
  // row tile and lane, 2 rows) and P fragments (2 x 4 words, 4 groups, a
  // lane of a row tile)
  static constexpr int xbytes = kRT * (kWP * kRows + 4 * 32 * 2 + 4 * 2 * 4 * 32) * 4;
  static constexpr int wins = scores + (kWP > 1 ? xbytes : 0);
  static constexpr int rowidx = wins + kRT * kRows * static_cast<int>(sizeof(Win));
  static constexpr int need = rowidx + kChunk * 4;
  static constexpr int scale = need + kChunk / 8;
  static constexpr int bytes = scale + (kQuant ? 2 * kChunk * 4 : 0);
  // the q tile: in the int8 widening buffer, or in the last ring slot
  static constexpr int qstage = kQuant ? conv : (kStages - 1) * 2 * kRaw;
  static_assert(kRT * kRows * kLd * 2 <= 2 * kTileBf, "the q tile fits its staging area");
};

// the int8 K and V rows of a stage (2 * kTile rows of D bytes) as exact
// bf16 rows of stride D + 8
template <int D, int kThr>
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src) {
  constexpr int kPer = D / 16;
  for (int x = threadIdx.x; x < 2 * kTile * kPer; x += kThr) {
    const int row = x / kPer, part = x % kPer;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * D + part * 16);
    const uint32_t r4[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bytes (0, 2, 1, 3) -> bf16 pairs (0, 1) and (2, 3)
      const uint32_t v = __byte_perm(r4[j], 0, 0x3120);
      w[2 * j] = ds_int8::s8x2_to_bf16x2(v);
      w[2 * j + 1] = ds_int8::s8x2_to_bf16x2(v >> 8);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + row * (D + 8) + part * 16);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// p as a bf16 high part and the bf16 rounding of what it leaves
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// kRT row tiles of 16 folded rows a CTA, kWP warps a row tile: kRT = 4,
// kWP = 1 (R > 16: the span modes) or kRT = 1, kWP = 4 (R <= 16: the
// decode modes). The kWP warps of a row tile split its scores and softmax
// by positions and its P V by columns. Whatever the layout, each score,
// softmax update and output element is the same sequence of instructions.
// (Two warps a row tile at R > 16 were slower: their exchange costs more
// than the split saves. The 64-row layout at R <= 16 made the decode rows
// 10-35% slower, two of them slower than PyTorch's attention call; one warp
// on 16 rows, slower still.)
template <int D, typename KV, bool kExt, int kRT, int kWP>
__global__ void __launch_bounds__(32 * kRT * kWP)
decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
              const __half* __restrict__ ks, const __half* __restrict__ vs,
              const int* __restrict__ start, const int* __restrict__ ends,
              const int* __restrict__ ext, const int* __restrict__ sink,
              const int* __restrict__ win, bf16* __restrict__ out, float* __restrict__ ws,
              float* __restrict__ ws_ml, int nkv, int R, int T, int S, int E, int NC,
              float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  using L = Smem<D, kQuant, kRT, kWP>;
  constexpr int kLd = L::kLd;
  constexpr int kThreads = 32 * kRT * kWP;
  constexpr int kGw = kTile / 16 / kWP;  // 16-position groups a warp
  constexpr int kPw = kTile / kWP;   // score positions a warp
  constexpr int kDw = D / kWP;       // output columns a warp
  constexpr int kCtaRows = kRT * kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sM = reinterpret_cast<float*>(smem + L::scores);  // [row tile][warp][row]
  float* sG = sM + kRT * kWP * kRows;                      // [row tile][group][lane][row]
  uint32_t* sP = reinterpret_cast<uint32_t*>(sG + kRT * 4 * 32 * 2);  // [row tile][group][hi, lo][reg][lane]
  Win* sw = reinterpret_cast<Win*>(smem + L::wins);
  int* rowidx = reinterpret_cast<int*>(smem + L::rowidx);
  uint32_t* need = reinterpret_cast<uint32_t*>(smem + L::need);
  float* ksf = reinterpret_cast<float*>(smem + L::scale);
  float* vsf = ksf + kChunk;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wt = warp / kWP, u = warp % kWP;  // this warp's row tile and share of it
  const int RT = (R + kCtaRows - 1) / kCtaRows;
  const int chunk = blockIdx.x % NC;
  const int rt = blockIdx.x / NC % RT;
  const int bh = blockIdx.x / NC / RT;
  const int b = bh / nkv, h = bh % nkv;
  const int r0 = rt * kCtaRows, nrows = min(kCtaRows, R - r0);
  const int cap = kExt ? E * S : S;
  const int lo = max(start[b], 0), e0 = ends[b];
  const int sk = win ? sink[b] : 0, wn = win ? win[b] : 0;
  const int c0 = chunk * kChunk, c1 = min(c0 + kChunk, cap);

  // the rows' windows (rows past R keep nothing); without a lossy hole the
  // rows keep [lo, hmax) between them, hmax the longest column's end
  bool mine = false;
  if (tid < kCtaRows) {
    Win w = row_win(lo, cap, e0 + (r0 + tid) % T, sk, wn);
    if (tid >= nrows) w.a_hi = w.b_lo = w.hi = lo;
    sw[tid] = w;
    mine = w.any_in(c0, c1);
  }
  const int r_hi = r0 % T + nrows - 1;  // the last row's column, unwrapped
  const int hmax = min(e0 + (r_hi >= T ? T - 1 : r_hi), cap);
  const bool any = __syncthreads_or(mine);
  bf16* ob = out + ((size_t)bh * R + r0) * D;
  if (chunk == 0) {  // a row that keeps nothing anywhere: exact zeros
    for (int x = tid; x < nrows * D; x += kThreads)
      if (sw[x / D].first() < 0) ob[x] = __float2bfloat16(0.f);
  }
  if (!any) return;

  // the chunk's positions: needed by some row?, where, (int8) their scales
  for (int j = tid; j < kChunk; j += kThreads) {
    const int p = c0 + j;
    bool nd = p >= lo && p < min(hmax, c1);
    if (wn > 0 && nd) {
      nd = false;
      for (int i = 0; i < nrows && !nd; ++i) nd = sw[i].keeps(p);
    }
    int ri = 0;
    float kscl = 0.f, vscl = 0.f;
    if (nd) {
      int prow = b, off = p;
      if constexpr (kExt) {
        const int e = p / S;
        off = p - e * S;
        prow = max(ext[(size_t)b * E + e], 0);
      }
      ri = (prow * nkv + h) * S + off;
      if constexpr (kQuant) {
        kscl = __half2float(ks[(size_t)prow * S + off]);
        vscl = __half2float(vs[(size_t)prow * S + off]);
      }
    }
    rowidx[j] = ri;
    if constexpr (kQuant) {
      ksf[j] = kscl;
      vsf[j] = vscl;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, nd);
    if (lane == 0) need[j / 32] = bits;
  }
  __syncthreads();

  uint32_t tiles = 0;  // the chunk's tiles some row keeps
#pragma unroll
  for (int t = 0; t < kChunk / kTile; ++t)
    if (need[2 * t] | need[2 * t + 1]) tiles |= 1u << t;

  uint32_t to_issue = tiles;
  auto issue = [&](int slot) {  // the next needed tile into ring slot `slot`
    if (to_issue) {
      const int t = __ffs(to_issue) - 1;
      to_issue &= to_issue - 1;
      unsigned char* st = smem + slot * 2 * L::kRaw;
      constexpr int kVec = kQuant ? 16 : 8;  // elements a 16-byte copy
      constexpr int kPer = D / kVec;
#pragma unroll
      for (int x = tid; x < kTile * kPer; x += kThreads) {
        const int pi = x / kPer, part = x % kPer;
        const int j = t * kTile + pi;
        const bool nd = (need[j / 32] >> (j % 32)) & 1u;
        const size_t src = nd ? (size_t)rowidx[j] * D + part * kVec : 0;
        const int dst = kQuant ? pi * D + part * 16 : (pi * kLd + part * 8) * 2;
        ds_int8::cp_async16(st + dst, kc + src, nd);
        ds_int8::cp_async16(st + L::kRaw + dst, vc + src, nd);
      }
    }
    ds_int8::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  // the q tiles (zeros past R), staged where no copy is in flight yet, as A
  // fragments
  bf16* qs = reinterpret_cast<bf16*>(smem + L::qstage);
  ds_mma::load_rows<D, kCtaRows>(qs, q + ((size_t)bh * R + r0) * D, 0, nrows);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ds_mma::ldsm_x4(qa[kk], qs + (wt * kRows + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);

  const Win wr[2] = {sw[wt * kRows + gq], sw[wt * kRows + gq + 8]};  // this lane's two rows
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kDw / 8][4];
  ds_mma::zero(acc);

  int i = 0;
  for (uint32_t todo = tiles; todo; todo &= todo - 1, ++i) {
    const int t = __ffs(todo) - 1;
    ds_int8::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    issue((i + kStages - 1) % kStages);
    const unsigned char* st = smem + (i % kStages) * 2 * L::kRaw;
    const bf16* Kt;
    const bf16* Vt;
    if constexpr (kQuant) {
      bf16* cv = reinterpret_cast<bf16*>(smem + L::conv);
      widen<D, kThreads>(cv, reinterpret_cast<const int8_t*>(st));
      __syncthreads();
      Kt = cv;
      Vt = cv + kTile * kLd;
    } else {
      Kt = reinterpret_cast<const bf16*>(st);
      Vt = reinterpret_cast<const bf16*>(st + L::kRaw);
    }

    // scores of positions [u kPw, (u + 1) kPw), times the scale (int8: and
    // each position's K scale)
    float sc[kPw / 8][4];
    ds_mma::zero(sc);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < kPw; n0 += 16) {
        uint32_t bfr[4];
        ds_mma::ldsm_x4(bfr, Kt + (u * kPw + n0 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        ds_mma::mma16816(sc[n0 / 8], qa[kk], bfr[0], bfr[1]);
        ds_mma::mma16816(sc[n0 / 8 + 1], qa[kk], bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kPw / 8; ++n) {
      const int col = u * kPw + n * 8 + 2 * tq;
      float f0 = c, f1 = c;
      if constexpr (kQuant) {
        f0 = c * ksf[t * kTile + col];
        f1 = c * ksf[t * kTile + col + 1];
      }
      sc[n][0] *= f0;
      sc[n][1] *= f1;
      sc[n][2] *= f0;
      sc[n][3] *= f1;
    }
    // the online softmax of this lane's two rows over the tile. A warp that
    // owns a row tile holds its 64 scores; four warps sharing one each hold
    // 16 positions and exchange the row max, their group sums and their P
    // fragments through shared memory. Either way a row takes the same max,
    // the same exponentials, its sum in the same pairwise tree (16-position
    // groups g0..g3, then (g0 + g1) + (g2 + g3)) and the same fragments.
    const int p0 = c0 + t * kTile;
    float alpha[2], sum[2];
    uint64_t kept[2];
    float mt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      kept[hr] = wr[hr].bits(p0) >> (2 * tq);  // bit 8 nt + j: position nt * 8 + 2 tq + j
      mt[hr] = -INFINITY;
#pragma unroll
      for (int n = 0; n < kPw / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mt[hr] = fmaxf(mt[hr], (kept[hr] >> (8 * (u * kPw / 8 + n) + j)) & 1u ? sc[n][2 * hr + j]
                                                                                : -INFINITY);
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(0xffffffffu, mt[hr], 2));
    }
    if constexpr (kWP > 1) {
      float* xm = sM + wt * kWP * kRows;
      if (tq == 0) {
        xm[u * kRows + gq] = mt[0];
        xm[u * kRows + gq + 8] = mt[1];
      }
      __syncthreads();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mt[hr] = xm[gq + 8 * hr];
#pragma unroll
        for (int w = 1; w < kWP; ++w) mt[hr] = fmaxf(mt[hr], xm[w * kRows + gq + 8 * hr]);
      }
    }
    float g[2][kPw / 16];  // this lane's 16-position group sums
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool active = mt[hr] != -INFINITY;  // a tile the row keeps nothing of is a no-op
      const float mn = active ? fmaxf(m[hr], mt[hr]) : m[hr];
      alpha[hr] = active ? ex2(m[hr] - mn) : 1.f;
#pragma unroll
      for (int n = 0; n < kPw / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = ex2(sc[n][2 * hr + j] - mn);  // selected away where not kept
          sc[n][2 * hr + j] = (kept[hr] >> (8 * (u * kPw / 8 + n) + j)) & 1u ? e : 0.f;
        }
#pragma unroll
      for (int q4 = 0; q4 < kPw / 16; ++q4)
        g[hr][q4] = (sc[2 * q4][2 * hr] + sc[2 * q4][2 * hr + 1]) +
                    (sc[2 * q4 + 1][2 * hr] + sc[2 * q4 + 1][2 * hr + 1]);
      m[hr] = mn;
    }
    // P (times the V scales) as bf16 high and low A fragments, 16 positions
    // (two score n-tiles) at a time
    auto p_frags = [&](int n, int kc2, uint32_t (&ph)[4], uint32_t (&pl)[4]) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = t * kTile + (2 * kc2 + half) * 8 + 2 * tq;
        const float f0 = kQuant ? vsf[pos] : 1.f, f1 = kQuant ? vsf[pos + 1] : 1.f;
        split_bf16(sc[n + half][0] * f0, sc[n + half][1] * f1, ph[2 * half], pl[2 * half]);
        split_bf16(sc[n + half][2] * f0, sc[n + half][3] * f1, ph[2 * half + 1], pl[2 * half + 1]);
      }
    };
    float* xg = sG + wt * 4 * 32 * 2;
    uint32_t* xp = sP + wt * 4 * 2 * 4 * 32;
    if constexpr (kWP == 1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) sum[hr] = (g[hr][0] + g[hr][1]) + (g[hr][2] + g[hr][3]);
    } else {
#pragma unroll
      for (int q = 0; q < kGw; ++q) {
        const int grp = u * kGw + q;
        uint32_t ph[4], pl[4];
        p_frags(2 * q, grp, ph, pl);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          xp[((grp * 2 + 0) * 4 + r) * 32 + lane] = ph[r];
          xp[((grp * 2 + 1) * 4 + r) * 32 + lane] = pl[r];
        }
        xg[(grp * 32 + lane) * 2] = g[0][q];
        xg[(grp * 32 + lane) * 2 + 1] = g[1][q];
      }
      __syncthreads();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        sum[hr] = (xg[lane * 2 + hr] + xg[(32 + lane) * 2 + hr]) +
                  (xg[(64 + lane) * 2 + hr] + xg[(96 + lane) * 2 + hr]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l[hr] = __fmaf_rn(l[hr], alpha[hr], sum[hr]);
    }

    // acc (16 x kDw) = acc * alpha + P V, 16 positions at a time
#pragma unroll
    for (int n = 0; n < kDw / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc2 = 0; kc2 < kTile / 16; ++kc2) {
      uint32_t ph[4], pl[4];
      if constexpr (kWP == 1) {
        p_frags(2 * kc2, kc2, ph, pl);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ph[r] = xp[((kc2 * 2 + 0) * 4 + r) * 32 + lane];
          pl[r] = xp[((kc2 * 2 + 1) * 4 + r) * 32 + lane];
        }
      }
#pragma unroll
      for (int n0 = 0; n0 < kDw; n0 += 16) {
        uint32_t bv[4];
        ds_mma::ldsm_x4_trans(bv, Vt + (kc2 * 16 + (lane & 15)) * kLd + u * kDw + n0 + (lane >> 4) * 8);
        ds_mma::mma16816(acc[n0 / 8], ph, bv[0], bv[1]);
        ds_mma::mma16816(acc[n0 / 8 + 1], ph, bv[2], bv[3]);
        ds_mma::mma16816(acc[n0 / 8], pl, bv[0], bv[1]);
        ds_mma::mma16816(acc[n0 / 8 + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // a row kept in this chunk alone is final here; a row over several chunks
  // leaves this chunk's (m, l, acc) for the merge
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wt * kRows + gq + 8 * hr;
    const Win& w = wr[hr];
    const int f = w.first();
    if (row >= nrows || f < 0 || !w.any_in(c0, c1)) continue;
    const size_t grow = (size_t)bh * R + r0 + row;
    if (f / kChunk == w.last() / kChunk) {
      const float inv = 1.f / (l[hr] == 0.f ? 1.f : l[hr]);
#pragma unroll
      for (int n = 0; n < kDw / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + grow * D + u * kDw + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
    } else {
      float* pa = ws + (grow * NC + chunk) * D + u * kDw;
#pragma unroll
      for (int n = 0; n < kDw / 8; ++n)
        *reinterpret_cast<float2*>(pa + n * 8 + 2 * tq) = make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
      if (u == 0 && tq == 0)
        *reinterpret_cast<float2*>(ws_ml + (grow * NC + chunk) * 2) = make_float2(m[hr], l[hr]);
    }
  }
}

// One warp a folded row kept over several chunks: its chunks' (m, l, acc)
// merged in chunk order, skipping the chunks its window keeps nothing of.
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws, const float* __restrict__ ws_ml, bf16* __restrict__ out,
             const int* __restrict__ start, const int* __restrict__ ends,
             const int* __restrict__ sink, const int* __restrict__ win, int rows, int nkv, int R,
             int T, int cap, int NC) {
  constexpr int kDl = D / 32;
  const int lane = threadIdx.x % 32;
  const int grow = blockIdx.x * (kMergeThreads / 32) + threadIdx.x / 32;
  if (grow >= rows) return;
  const int r = grow % R, b = grow / R / nkv;
  const Win w = row_win(max(start[b], 0), cap, ends[b] + r % T, win ? sink[b] : 0,
                        win ? win[b] : 0);
  const int f = w.first();
  if (f < 0 || f / kChunk == w.last() / kChunk) return;
  const int kf = f / kChunk, kl = w.last() / kChunk;
  float M = -INFINITY;
  for (int k = kf; k <= kl; ++k)
    if (w.any_in(k * kChunk, min(k * kChunk + kChunk, cap)))
      M = fmaxf(M, ws_ml[((size_t)grow * NC + k) * 2]);
  float Lsum = 0.f, A[kDl];
#pragma unroll
  for (int j = 0; j < kDl; ++j) A[j] = 0.f;
  for (int k = kf; k <= kl; ++k) {
    if (!w.any_in(k * kChunk, min(k * kChunk + kChunk, cap))) continue;
    const size_t at = (size_t)grow * NC + k;
    const float fk = ex2(ws_ml[at * 2] - M);
    Lsum = Lsum + ws_ml[at * 2 + 1] * fk;
#pragma unroll
    for (int j = 0; j < kDl; ++j) A[j] = A[j] + ws[at * D + lane * kDl + j] * fk;
  }
  const float inv = 1.f / Lsum;
#pragma unroll
  for (int j = 0; j < kDl; ++j) out[(size_t)grow * D + lane * kDl + j] = __float2bfloat16(A[j] * inv);
}

int chunks(int S, int E) { return (S * E + kChunk - 1) / kChunk; }

template <int D, typename KV, bool kExt, int kRT, int kWP>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* start, const void* ends, const void* ext, const void* sink, const void* win,
           void* out, void* ws, int B, int nkv, int R, int T, int S, int E, float scale,
           cudaStream_t s) {
  constexpr int smem = Smem<D, sizeof(KV) == 1, kRT, kWP>::bytes;
  static bool sized = false;  // the shared-memory limit, raised once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<D, KV, kExt, kRT, kWP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int NC = chunks(S, kExt ? E : 1);
  const int rows = B * nkv * R;
  float* wsp = static_cast<float*>(ws);
  float* ws_ml = NC > 1 ? wsp + (size_t)rows * NC * D : nullptr;
  const unsigned grid = (unsigned)B * nkv * ((R + kRT * kRows - 1) / (kRT * kRows)) * NC;
  const auto* sp = static_cast<const int*>(start);
  const auto* ep = static_cast<const int*>(ends);
  const auto* skp = static_cast<const int*>(sink);
  const auto* wp = static_cast<const int*>(win);
  auto* op = static_cast<bf16*>(out);
  decode_kernel<D, KV, kExt, kRT, kWP><<<grid, 32 * kRT * kWP, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs), sp, ep,
      static_cast<const int*>(ext), skp, wp, op, wsp, ws_ml, nkv, R, T, S, E, NC, scale);
  if (NC > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_kernel<D><<<(rows + kMergeThreads / 32 - 1) / (kMergeThreads / 32), kMergeThreads, 0, s>>>(
        wsp, ws_ml, op, sp, ep, skp, wp, rows, nkv, R, T, kExt ? E * S : S, NC);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch_kv(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* start, const void* ends, const void* ext, const void* sink,
              const void* win, void* out, void* ws, int B, int nkv, int R, int T, int S, int E,
              int D, float scale, cudaStream_t s) {
#define DS_DECODE(Dv, X, RT, WP) \
  launch<Dv, KV, X, RT, WP>(q, k, v, ks, vs, start, ends, ext, sink, win, out, ws, B, nkv, R, T, S, E, scale, s)
#define DS_DECODE_R(Dv, X) (R > kRows ? DS_DECODE(Dv, X, 4, 1) : DS_DECODE(Dv, X, 1, 4))
  if (D == 64) return ext ? DS_DECODE_R(64, true) : DS_DECODE_R(64, false);
  if (D == 128) return ext ? DS_DECODE_R(128, true) : DS_DECODE_R(128, false);
#undef DS_DECODE_R
#undef DS_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fp32 elements of the workspace decode_launch needs: 0 when the logical
// window fits one chunk (E * S <= 512), else (D + 2) per folded row and chunk
DS_EXPORT long long decode_workspace(int B, int nkv, int R, int S, int E, int D) {
  const int NC = chunks(S, E);
  return NC > 1 ? (long long)B * nkv * R * NC * (D + 2) : 0;
}

// Device pointers; the caller checked shapes, types, contiguity and D in
// {64, 128}. q/out hold R folded rows per (row, kv head), T span columns
// with the column fastest (T = 1 in the decode modes). ``quant``: int8 K/V
// with (Np, S) fp16 row scales ks/vs (null otherwise). ``ext``: the (B, E)
// extent table of the extent modes, or null (the pool row of row b is b,
// E = 1); ``sink``/``win``: (B,) lossy-window bounds, or null (none).
// ``ws``: decode_workspace(...) fp32 elements of scratch (null when 0).
// Returns cudaGetLastError().
DS_EXPORT int decode_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* start,
                            const void* ends, const void* ext, const void* sink, const void* win,
                            void* out, void* ws, int B, int nkv, int R, int T, int S, int E, int D,
                            int quant, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ext) E = 1;
  if (quant)
    return launch_kv<int8_t>(q, k_cache, v_cache, k_scale, v_scale, start, ends, ext, sink, win,
                             out, ws, B, nkv, R, T, S, E, D, scale, s);
  return launch_kv<__nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, start, ends, ext, sink,
                                  win, out, ws, B, nkv, R, T, S, E, D, scale, s);
}
