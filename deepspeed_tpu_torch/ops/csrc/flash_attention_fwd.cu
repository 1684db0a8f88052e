// FlashAttention forward with log-sum-exp, for Hopper: wgmma, a TMA
// producer warp and an mbarrier K/V ring.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py::_fwd_kernel.
// Same function: softmax(scale * q k^T [causal]) v with an fp32 online
// softmax, GQA-native (query head h reads KV head h / (H / Hkv)), causality
// top-left aligned (col <= row, also when Tk != T), and the per-row
// log-sum-exp; a row that attends nothing gets out = 0, lse = -inf. As in
// the TPU kernel, the probabilities are rounded to bf16 before the P V
// product and the row sums take them unrounded.
//
// Layout (the JAX one): q (B, H, T, D), k/v (B, Hkv, Tk, D) bf16, contiguous,
// 16-byte aligned (TMA's base alignment); out (B, H, T, D) bf16; lse (B, H, T)
// fp32. D is 64 or 128; T and Tk are any length; scale > 0.
//
// What bounds it on the H100: the 4*T*Tk*D multiply-add operations per head
// (halved by causality) against the 989 TFLOP/s of the bf16 tensor cores at
// training lengths, and about as much the bytes (q, k, v, out once) at
// D = 64; at short prefills (T = 128) the bytes and the latency of one
// tile's walk. At D = 64 the softmax's exp2 (the SFU's 16 a cycle an SM)
// costs as much as the two products.
//
// Design. A CTA is WG consumer warpgroups of 64 query rows (the q tile is
// 64 * WG rows) and one producer warp. The producer's lane loads the Q tile,
// then streams the 128-key K and V tiles through a ring of kStages slots with
// TMA (separate full and empty mbarriers for K and V, so a K slot refills as
// soon as the scores that read it are done). The tensor maps are 3D,
// (D, T, B*H) and (D, Tk, B*Hkv), boxes of 64 columns in the 128-byte
// swizzle (two boxes a row at D = 128): a box at the T or Tk edge fills
// zeros instead of reading the next head's rows, so nothing past Tk is read
// (a NaN there changes no bit). A consumer warpgroup computes S = Q K^T with
// wgmma m64n128k16, both operands K-major in shared memory; masks only the
// diagonal tile and the Tk edge tile (tiles past the diagonal are never
// loaded); takes the row max over each quad and exp2 of s * scale * log2(e) - m; rescales O;
// rounds P to bf16 straight from the score accumulators into wgmma's A
// registers (mma.m16n8k16's A layout per warp); and computes O += P V with
// wgmma m64nDk16, V the B operand MN-major (transposed) from the same
// swizzled tile.
//   The grid is persistent: as many CTAs as fit on the card, each walking
// q tiles numbered heaviest first (every head of a tile together) and dealt
// in a snake, so under causality the long walks start first and the CTAs
// finish together; the producer loads the next tile's Q and K/V while the
// consumers finish the last one, so a tile's start latency is hidden.
//   Tilings (measured; PERF.md): at D = 64 one warpgroup a CTA and three
// CTAs an SM, whose softmaxes and products interleave by chance (two
// warpgroups of one CTA wait on the same slots and run in step); under the
// 136-register cap that allows, ptxas spills a few bytes. At D = 128 two
// warpgroups a CTA, one CTA an SM. No setmaxnreg: the producer is a single
// warp, and the consumers' accumulators (O, S and P; 168 registers a thread
// at D = 128) fit as they are.
//
// Later work: softmax overlapping the next tile's Q K^T (ping-pong between
// the warpgroups, or two score buffers in one), clusters with TMA multicast
// of K/V across a GQA group, a TMA store of O, fp8.

#include <math.h>

#include "hopper.cuh"

namespace {

using ds_mma::bf16;
using ds_mma::pack_bf16;
using namespace ds_hopper;

constexpr int kBk = 128;                // keys a K/V tile
constexpr int kBox = 64;                // bf16 columns a TMA box: one 128-byte swizzled row
constexpr int kKVBlockBytes = kBk * 128;  // 64 columns of a K or V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a CTA: WG consumer warpgroups of 64 query rows and one producer warp
template <int D>
struct Cfg {
  static constexpr int WG = D == 128 ? 2 : 1;
  static constexpr int kBq = 64 * WG;                   // query rows a CTA
  static constexpr int kThreads = WG * 128 + 32;
  static constexpr int kStages = 2;
  static constexpr int kQBlockBytes = kBq * 128;        // 64 columns of the Q tile
  static constexpr int kQBytes = kBq * D * 2;
  static constexpr int kKVBytes = kBk * D * 2;          // a K or V tile
  static constexpr int kBars = 2 + 4 * kStages;         // Q full and empty; K, V full and empty a slot
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + kBars * 8 + 1024;  // + 1024-byte alignment
  // D = 64: three CTAs an SM (at most 136 registers a thread)
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int T, int Tk, int BH, int n_q,
                 float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  constexpr int kCB = D / kBox;  // 64-column blocks of a row
  constexpr int kConsumerWarps = C::WG * 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte atoms
  uint8_t* ks = qs + C::kQBytes;  // slot s at ks + s * kKVBytes
  uint8_t* vs = ks + S * C::kKVBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(vs + S * C::kKVBytes);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = empty_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = n_q * BH;
  // work item n of this CTA: items are numbered heaviest q tile first, every
  // head of a tile together, and dealt to the CTAs in a snake (forward on
  // even rounds, backward on odd), so the CTAs' sums of walks stay level
  auto item_of = [&](int n) {
    const int c = blockIdx.x, G = gridDim.x;
    return n * G + ((n & 1) ? G - 1 - c : c);
  };
  auto tiles_of = [&](int q0) {  // K/V tiles of a q tile; causal: none past the diagonal
    const int n = (Tk + kBk - 1) / kBk;
    return causal ? min(n, (q0 + C::kBq - 1) / kBk + 1) : n;
  };

  if (tid == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumerWarps);
      mbar_init(&empty_v[s], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: Q, then K/V through the ring, item after item
    if (lane == 0) {
      int it = 0;  // K/V tiles streamed so far (the ring's position)
      for (int n = 0;; ++n) {
        const int item = item_of(n);
        if (item >= n_items) break;
        const int q0 = (n_q - 1 - item / BH) * C::kBq, bh = item % BH;
        const int kvbh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);
        mbar_expect_tx(full_q, C::kQBytes);
        for (int c = 0; c < kCB; ++c) tma_load_3d(qs + c * C::kQBlockBytes, &tq, c * kBox, q0, bh, full_q);
        const int n_tiles = tiles_of(q0);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty_k[s], (it / S - 1) & 1);
          mbar_expect_tx(&full_k[s], C::kKVBytes);
          for (int c = 0; c < kCB; ++c)
            tma_load_3d(ks + s * C::kKVBytes + c * kKVBlockBytes, &tk, c * kBox, j * kBk, kvbh, &full_k[s]);
          if (it >= S) mbar_wait(&empty_v[s], (it / S - 1) & 1);
          mbar_expect_tx(&full_v[s], C::kKVBytes);
          for (int c = 0; c < kCB; ++c)
            tma_load_3d(vs + s * C::kKVBytes + c * kKVBlockBytes, &tv, c * kBox, j * kBk, kvbh, &full_v[s]);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup: rows q0 + 64 wg ..
  const int col2 = 2 * (lane & 3);
  const uint8_t* qw = qs + wg * 64 * 128;  // the warpgroup's 64 rows of each column block
  int it = 0;
  for (int n = 0;; ++n) {
    const int item = item_of(n);
    if (item >= n_items) break;
    const int q0 = (n_q - 1 - item / BH) * C::kBq, bh = item % BH;
    const int row0 = q0 + wg * 64;
    const int row_lo = row0 + (warp & 3) * 16 + (lane >> 2);  // this lane's rows: row_lo, row_lo + 8
    const int n_tiles = tiles_of(q0);  // kBq <= kBk: each tile holds keys of every warpgroup's rows

    // accumulator 4i..4i+3 is n8 tile i: (row_lo, 8i + col2 + {0, 1}), (row_lo + 8, ...)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // m: running max of each row in log2 units (uniform over the row's quad);
    // l: this lane's share of the row's running sum, summed over the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(full_q, n & 1);
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % S, ph = (it / S) & 1;
      const uint8_t* kst = ks + s * C::kKVBytes;
      const uint8_t* vst = vs + s * C::kKVBytes;
      float sc[64];
      mbar_wait(&full_k[s], ph);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {  // a k16 step is 32 bytes along the swizzled row
        const int c = t / 4, k32 = (t % 4) * 32;
        wgmma_ss_m64n128(sc, sw128_desc(qw + c * C::kQBlockBytes + k32),
                         sw128_desc(kst + c * kKVBlockBytes + k32), t > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty_k[s]);
        if (j == n_tiles - 1) mbar_arrive(empty_q);  // Q's last reader: the next item's Q may load
      }

      const int k0 = j * kBk;
      if (k0 + kBk > Tk || (causal && k0 + kBk - 1 > row0)) {  // the edge or the diagonal
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_lo + (e >> 1) * 8, col = k0 + 8 * i + col2 + (e & 1);
            if (col >= Tk || (causal && col > row)) sc[4 * i + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: every p and alpha is 0 either way
        alpha[r] = ex2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -mu[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P as A fragments, keys 16kc..16kc+15: n8 tiles 2kc and 2kc + 1 (the bf16 rounding point)
      uint32_t pf[8][4];
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        pf[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
        pf[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        pf[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        pf[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
      }

      mbar_wait(&full_v[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {  // a k16 step is 16 key rows, 2048 bytes
        wgmma_rs_mn<D>(o, pf[kc], sw128_mn_desc(vst + kc * 16 * 128, kKVBlockBytes), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_v[s]);
    }

    if (n_tiles == 0 && lane == 0) mbar_arrive(empty_q);  // Tk = 0: nothing read Q

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
    }
    bf16* ob = out + (size_t)bh * T * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < T) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * i + col2) =
              __floats2bfloat162_rn(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
        if ((lane & 3) == 0) lse[(size_t)bh * T + row] = l[h] == 0.f ? -INFINITY : m[h] * kLn2 + logf(l[h]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Hkv, int T, int Tk, float scale, int causal, cudaStream_t s) {
  using C = Cfg<D>;
  static bool attr = false;
  if (const int rc = set_smem(flash_fwd_kernel<D>, C::kSmem, attr)) return rc;
  if (B * H * T == 0) return 0;
  // with Tk = 0 no tile is loaded: the K/V maps only need a valid base
  const void* kb = Tk ? k : q;
  const void* vb = Tk ? v : q;
  CUtensorMap tq, tk, tv;
  if (const int rc = bf16_map(&tq, q, D, T, B * H, C::kBq)) return rc;
  if (const int rc = bf16_map(&tk, kb, D, Tk ? Tk : 1, B * Hkv, kBk)) return rc;
  if (const int rc = bf16_map(&tv, vb, D, Tk ? Tk : 1, B * Hkv, kBk)) return rc;
  // a persistent grid: as many CTAs as fit on the card at once, each
  // walking its share of the q tiles
  static int dev_cached = -1, resident = 0;
  if (const int rc = resident_ctas(flash_fwd_kernel<D>, C::kThreads, C::kSmem, dev_cached, resident))
    return rc;
  const int n_q = (T + C::kBq - 1) / C::kBq;
  flash_fwd_kernel<D><<<min(n_q * B * H, resident), C::kThreads, C::kSmem, s>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv, T, Tk, B * H, n_q,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, 16-byte
// alignment, D in {64, 128}, H % Hkv == 0 and scale > 0. Returns
// cudaGetLastError() (or the error of the shared-memory attribute call, of
// the occupancy query or of a tensor map's encoding).
DS_EXPORT int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int H, int Hkv, int T, int Tk, int D,
                               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  if (D == 128) return launch<128>(q, k, v, out, lse, B, H, Hkv, T, Tk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
