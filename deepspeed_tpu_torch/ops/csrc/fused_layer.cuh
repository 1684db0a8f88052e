// Pieces kernels A and C of the fused decode layer share (fused_qkv_ln.cu,
// fused_out_mlp.cu): the norm pass that writes a row's normalized bf16
// values once, the activations, and the operands of a product on
// qmm_core.cuh's mainloops.
//
// Batch invariance reaches the epilogues too: an epilogue is elementwise
// and runs in two places (the wgmma block's staged tile, the reduce of a
// split plan), so its arithmetic is written in round-to-nearest intrinsics
// (__fadd_rn, __fmul_rn, __fdiv_rn: never contracted into an fma
// differently in the two) and the activations' transcendentals on the SFU. The norm pass is
// one launch for every M, a block a row, its sums in a fixed order.
#pragma once

#include <math.h>

#include "qmm_core.cuh"

namespace ds_fused {

using ds_qmm::bf16;
using ds_qmm::Fin;
using ds_qmm::Operands;

constexpr int kNormThreads = 256;

__device__ __forceinline__ float4 load4(const bf16* p) {  // 4 bf16 in 8 bytes
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// the sum over the block of each thread's s, in a fixed order (every thread
// gets it); red holds a float a warp
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // the previous sum's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) t += red[w];
  return t;
}

// y[m] = bf16(norm(x[m]) * scale + bias), one block a row, as the JAX
// kernels' _norm: layernorm mu = mean(x), var = mean((x - mu)^2) (two
// passes), rmsnorm mu = 0, var = mean(x^2), no bias. H % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int H, float eps, int rms) {
  __shared__ float red[kNormThreads / 32];
  ds_qmm::pdl_release();
  ds_qmm::pdl_wait();
  const T* row = x + (size_t)blockIdx.x * H;
  const int n4 = H / 4;
  float s = 0.f;
  if (!rms) {
    for (int j = threadIdx.x; j < n4; j += kNormThreads) {
      const float4 v = load4(row + 4 * j);
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  const float mu = rms ? 0.f : block_sum(s, red) / H;
  s = 0.f;
  for (int j = threadIdx.x; j < n4; j += kNormThreads) {
    const float4 v = load4(row + 4 * j);
    const float a = v.x - mu, b = v.y - mu, c = v.z - mu, d = v.w - mu;
    s += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = 1.f / sqrtf(block_sum(s, red) / H + eps);
  bf16* out = y + (size_t)blockIdx.x * H;
  for (int j = threadIdx.x; j < n4; j += kNormThreads) {
    const float4 v = load4(row + 4 * j);
    const float4 g = *reinterpret_cast<const float4*>(scale + 4 * j);
    const float4 b = rms ? make_float4(0.f, 0.f, 0.f, 0.f) : *reinterpret_cast<const float4*>(bias + 4 * j);
    __nv_bfloat162 lo = __floats2bfloat162_rn((v.x - mu) * rstd * g.x + b.x, (v.y - mu) * rstd * g.y + b.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn((v.z - mu) * rstd * g.z + b.z, (v.w - mu) * rstd * g.w + b.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + 4 * j) = u;
  }
}

template <typename T>
int launch_norm(const T* x, const float* scale, const float* bias, bf16* y, int M, int H, float eps,
                int rms, cudaStream_t s) {
  return ds_qmm::launch_k(norm_rows_kernel<T>, dim3(M), kNormThreads, 0, s, true, x, scale, bias, y, H, eps, rms);
}

// The SFU's approximations: one instruction each, the same bits wherever
// they run
__device__ __forceinline__ float sfu_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sfu_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sfu_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// h / (1 + e^(-k h))
__device__ __forceinline__ float sigmoid_times(float h, float k) {
  return __fmul_rn(h, sfu_rcp(__fadd_rn(1.f, sfu_ex2(__fmul_rn(h, -1.4426950408889634f * k)))));
}

// activation codes (ops/decode_block.py::_ACTS). kAct: the code, fixed at
// compile time for the main paths' activations (0, gelu; 3, silu), or -1 to
// take act at run time. Written in round-to-nearest intrinsics and SFU
// instructions so that a value's bits do not depend on where the epilogue
// ran.
template <int kAct>
__device__ __forceinline__ float activate(float h, int act) {
  switch (kAct >= 0 ? kAct : act) {
    case 0: {  // gelu, tanh approximation
      const float h3 = __fmul_rn(__fmul_rn(h, h), h);
      const float t = sfu_tanh(__fmul_rn(0.7978845608028654f, __fadd_rn(h, __fmul_rn(0.044715f, h3))));
      return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, t));
    }
    case 1:  // gelu, erf
      return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erff(__fmul_rn(h, 0.7071067811865476f))));
    case 2:  // quick_gelu
      return sigmoid_times(h, 1.702f);
    case 3:  // silu
      return sigmoid_times(h, 1.f);
    default:  // relu
      return fmaxf(h, 0.f);
  }
}

__device__ __forceinline__ float2 ldg2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// a product's operands: x (M, K) bf16 against one or two int8 (K, N)
// weights with (G, N) scales; ws and flags as qmm_core.cuh's Operands
inline Operands make_ops(const void* x, const void* w0, const void* s0, const void* w1, const void* s1,
                         void* ws, void* flags, int M, int K, int N, int G) {
  const int gs = K / G;
  const int spg = (gs + ds_qmm::kSegK - 1) / ds_qmm::kSegK;
  return Operands{static_cast<const bf16*>(x),
                  {static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1)},
                  {static_cast<const float*>(s0), static_cast<const float*>(s1)},
                  static_cast<float*>(ws), static_cast<int*>(flags), M, K, N, gs, spg, G * spg,
                  w1 == nullptr ? 1 : 2};
}

}  // namespace ds_fused
