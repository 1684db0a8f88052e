// Kernel C of the fused decode layer, for every row the scheduler gives it
// (decode, verify and chunk steps alike):
//   res2  = attn @ dequant(Wo) + o_bias + x                       (fp32)
//   h     = act(norm2(res2) @ dequant(Wup) + up_bias)             (ungated)
//         | act(norm2(res2) @ dequant(Wgate) + gate_bias) * (norm2(res2) @ dequant(Wup) + up_bias)
//   out   = res2 + h @ dequant(Wdown) + down_bias                 (cast to bf16 last)
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_block.py::
// _out_mlp_kernel. Same arithmetic: res2 stays fp32; norm2 is taken in fp32
// and cast to bf16 before the up (and gate) dot; each quantization
// segment's fp32 partial is multiplied by its scale row; the activation
// (silu for swiglu, tanh gelu for geglu) applies to the gate; h is cast to
// bf16 before the down dot. One difference, by design: the TPU kernel keeps
// the up and gate partial sums in bf16 between k-blocks; here they stay
// fp32.
//
// Layout (the JAX one): attn (M, Ko) bf16; x (M, H) bf16; norms (4, H) fp32,
// rows 2 and 3 used; o (Ko, H), up and gate (H, F), down (F, H) int8 with
// (G, N) fp32 scales and (N,) fp32 biases; out (M, H) bf16.
//
// What bounds it on the H100: at decode the weight bytes, Ko*H + (2 or 3)*H*F
// int8 plus scales, over 3.35 TB/s (gpt2-large about 15.2 MB, 4.6 us;
// llama3-8b about 193 MB, 59 us); at the chunk step the 2*M*(Ko*H + (2 or
// 3)*H*F) operations over the 989 TFLOP/s of the bf16 tensor cores
// (gpt2-large M = 512: 15.1 GFLOP, 15.3 us; llama3-8b M = 256: 98.8 GFLOP,
// 100 us).
//
// Design. norm2 needs every column of the o projection and the down
// projection every column of h, so the TPU kernel runs its phases in order
// along one sequential grid axis. Here they are launches in stream order,
// issued by one call (no grid-wide barrier, nothing a CUDA graph must treat
// apart):
//  1. o: the product on qmm_core.cuh's mainloops (the same code and sum as
//     quant_matmul), its epilogue res2 = (sum + o_bias) + x in fp32;
//  2. norm2: a block a row writes norm2(res2) as bf16 once (fused_layer.cuh);
//  3. up (and gate, a second pass of the same call over the same rows: the
//     up and gate sums of a (row, column) meet in one block, two chains,
//     the first parked in shared memory while the second runs), its
//     epilogue h = act(gate + b) * (up + b) or act(up + b), as bf16;
//  4. down, its epilogue out = bf16((res2 + sum) + down_bias).
// Each product is mma.sync at M <= 32 (K split over blocks; a tile's last
// block chains the segment partials in order and runs the epilogue) or
// wgmma with TMA-fed tiles at M > 32 (the chain in registers; partials and
// an ordered reduce launch where the row tiles alone leave the card idle),
// as the wrapper's plan says; a row's bits depend on neither. 4 launches at
// M <= 32 and for the chain plans, up to 7 with split wgmma plans; each
// starts early under programmatic dependent launch and waits for its
// predecessor before it reads or writes anything but weights.
//   The choice, measured (chip_smoke.py's rows, NVIDIA H100 80GB HBM3, 700
// W; PERF.md §6): the earlier design, one cooperative launch with two
// grid-wide barriers on CUDA-core FMAs, took 0.0755 ms at gpt2-large B 8
// and 2.0949 ms at M = 512; these launches take 0.051 and 0.103 ms, so a
// persistent variant was not built. At decode the last-block chain costs
// device time over a separate reduce launch (0.0385 ms for C at B 8) and
// saves a launch's host time a product, which a host-bound decode step
// needs more.

#include "fused_layer.cuh"

namespace {

using namespace ds_qmm;

// Each epilogue takes columns n, n + 1 of row m.
struct OEpi {  // res2 = (sum + o_bias) + x
  static constexpr bool kStaged = true;
  static constexpr int kPasses = 1;
  const float* bias;
  const bf16* x;
  float* res2;
  int N;
  __device__ __forceinline__ void operator()(const Fin& f, int r, int c, int m, int n) const {
    const size_t at = (size_t)m * N + n;
    const float2 b = ds_fused::ldg2(bias + n), xv = ds_fused::ldg2(x + at);
    ds_fused::st2(res2 + at, __fadd_rn(__fadd_rn(f(0, r, c), b.x), xv.x),
                  __fadd_rn(__fadd_rn(f(0, r, c + 1), b.y), xv.y));
  }
};

// h = act(gate + gate_bias) * (up + up_bias), or act(up + up_bias). kAct and
// kGated: the activation and the gating, fixed at compile time for the main
// paths (gelu ungated, silu gated), or -1 to take them at run time.
template <int kAct, int kGated>
struct MlpEpi {
  static constexpr bool kStaged = true;
  static constexpr int kPasses = kGated == 0 ? 1 : 2;
  const float* up_bias;
  const float* gate_bias;
  bf16* h;
  int N, act, gated;
  __device__ __forceinline__ float one(const Fin& f, int r, int c, float ub, float gb) const {
    const float u = __fadd_rn(f(0, r, c), ub);
    if (kGated == 1 || (kGated < 0 && gated))
      return __fmul_rn(ds_fused::activate<kAct>(__fadd_rn(f(1, r, c), gb), act), u);
    return ds_fused::activate<kAct>(u, act);
  }
  __device__ __forceinline__ void operator()(const Fin& f, int r, int c, int m, int n) const {
    const float2 ub = ds_fused::ldg2(up_bias + n);
    const float2 gb = kPasses > 1 && (kGated == 1 || gated) ? ds_fused::ldg2(gate_bias + n) : make_float2(0.f, 0.f);
    ds_fused::st2(h + (size_t)m * N + n, one(f, r, c, ub.x, gb.x), one(f, r, c + 1, ub.y, gb.y));
  }
};

struct DownEpi {  // out = bf16((res2 + sum) + down_bias)
  static constexpr bool kStaged = true;
  static constexpr int kPasses = 1;
  const float* bias;
  const float* res2;  // written by an earlier launch: read-only here
  bf16* out;
  int N;
  __device__ __forceinline__ void operator()(const Fin& f, int r, int c, int m, int n) const {
    const size_t at = (size_t)m * N + n;
    const float2 b = ds_fused::ldg2(bias + n), rv = ds_fused::ldg2(res2 + at);
    ds_fused::st2(out + at, __fadd_rn(__fadd_rn(rv.x, f(0, r, c)), b.x),
                  __fadd_rn(__fadd_rn(rv.y, f(0, r, c + 1)), b.y));
  }
};

}  // namespace

// Device pointers; the caller checked shapes, types, contiguity, H % 4 == 0,
// F % 4 == 0 and 16-byte alignment. gate pointers are null for an ungated
// MLP. res2 (M x H fp32), ln2 (M x H bf16) and h (M x F bf16) hold the
// intermediate rows; ws the segment partials of the largest split plan of
// the three products (null when none has one); flags one zeroed int a block
// tile of the mma.sync plans, left zeroed. (bm, splits) of o, up and
// down: their plans (ops/decode_block.py::_plan). plant: a check of the
// invariance gate, 0 on the main path. Returns the first launch error.
DS_EXPORT int out_mlp_launch(const void* attn, const void* x, const void* norms, const void* o_w,
                             const void* o_s, const void* o_b, const void* up_w, const void* up_s,
                             const void* up_b, const void* gt_w, const void* gt_s,
                             const void* gt_b, const void* dn_w, const void* dn_s,
                             const void* dn_b, void* out, void* res2, void* ln2, void* h, void* ws, void* flags,
                             int M, int H, int F, int Ko, int Go, int Gu, int Gd, int bm_o, int sp_o,
                             int bm_u, int sp_u, int bm_d, int sp_d, int act, float eps, int rms,
                             int plant, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* nrm = static_cast<const float*>(norms);
  float* r2 = static_cast<float*>(res2);
  int rc = ds_qmm::run_product(ds_fused::make_ops(attn, o_w, o_s, nullptr, nullptr, ws, flags, M, Ko, H, Go),
                       OEpi{static_cast<const float*>(o_b), static_cast<const bf16*>(x), r2, H}, bm_o,
                       sp_o, plant, s);
  if (rc) return rc;
  rc = ds_fused::launch_norm(static_cast<const float*>(r2), nrm + 2 * H, nrm + 3 * H,
                             static_cast<bf16*>(ln2), M, H, eps, rms, s);
  if (rc) return rc;
  {
    const ds_qmm::Operands op = ds_fused::make_ops(ln2, up_w, up_s, gt_w, gt_s, ws, flags, M, H, F, Gu);
    const float* ub = static_cast<const float*>(up_b);
    const float* gb = static_cast<const float*>(gt_b);
    bf16* hh = static_cast<bf16*>(h);
    const int gated = gt_w != nullptr;
    if (act == 0 && !gated)  // gpt2's gelu
      rc = ds_qmm::run_product(op, MlpEpi<0, 0>{ub, gb, hh, F, act, gated}, bm_u, sp_u, plant, s);
    else if (act == 3 && gated)  // llama's swiglu
      rc = ds_qmm::run_product(op, MlpEpi<3, 1>{ub, gb, hh, F, act, gated}, bm_u, sp_u, plant, s);
    else
      rc = ds_qmm::run_product(op, MlpEpi<-1, -1>{ub, gb, hh, F, act, gated}, bm_u, sp_u, plant, s);
  }
  if (rc) return rc;
  return ds_qmm::run_product(ds_fused::make_ops(h, dn_w, dn_s, nullptr, nullptr, ws, flags, M, F, H, Gd),
                     DownEpi{static_cast<const float*>(dn_b), r2, static_cast<bf16*>(out), H}, bm_d,
                     sp_d, plant, s);
}
