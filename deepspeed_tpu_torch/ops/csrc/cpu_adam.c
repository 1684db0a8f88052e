/* Host (CPU) fused AdamW/Adam step over flat float buffers.
 *
 * Copy of deepspeed_tpu/ops/csrc/cpu_adam.c for the PyTorch port (bound by
 * deepspeed_tpu_torch/ops/adam/cpu_adam.py over CPU torch tensors, built
 * without -fopenmp: the binding steps pieces of a tensor on its own
 * threads, so the pragmas below are inert there); only
 * ds_f32_to_bf16's NaN differs: it writes 0xFFFF, as torch's vectorized CPU
 * cast of a contiguous tensor does, so a host cast is bitwise
 * .to(torch.bfloat16).
 *
 * Equivalent of the reference's vectorized CPU optimizer
 * (csrc/adam/cpu_adam.cpp, Adam_Optimizer::Step_AVX in
 * csrc/includes/cpu_adam.h:72): steps ZeRO-Offload'ed optimizer state
 * resident in host DRAM. Where the reference hand-writes AVX-512/AVX-256
 * intrinsics, this implementation is plain elementwise C compiled with
 * -O3 -march=native -fopenmp — the loops are exactly the shape the
 * auto-vectorizer turns into the same AVX code, on x86 and ARM hosts.
 *
 * Math matches optax.adamw bit-for-bit in fp32:
 *   m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2
 *   p -= lr * ( (m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps) + wd*p )
 * (plain Adam mode folds wd into the gradient instead).
 *
 * grad_coef folds loss-scale unscaling, gradient-accumulation averaging and
 * clipping into the single pass over the gradient.
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

void ds_adamw_step(float *p, float *m, float *v, const float *g, int64_t n,
                   float lr, float beta1, float beta2, float eps,
                   float weight_decay, int64_t step, float grad_coef,
                   int adamw_mode) {
  const float bc1 = 1.0f - powf(beta1, (float)step);
  const float bc2 = 1.0f - powf(beta2, (float)step);
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float gi = g[i] * grad_coef;
    if (!adamw_mode && weight_decay != 0.0f) gi += weight_decay * p[i];
    float mi = beta1 * m[i] + (1.0f - beta1) * gi;
    float vi = beta2 * v[i] + (1.0f - beta2) * gi * gi;
    m[i] = mi;
    v[i] = vi;
    float upd = (mi * inv_bc1) / (sqrtf(vi * inv_bc2) + eps);
    if (adamw_mode && weight_decay != 0.0f) upd += weight_decay * p[i];
    p[i] -= lr * upd;
  }
}

/* Same step but consuming bfloat16 gradients as produced on-device (ZeRO-
 * Offload ships compute-dtype gradients over the host link at half the
 * bytes; reference stage_1_and_2.py:1031 similarly accumulates fp16 grads
 * into fp32 on the host). */
void ds_adamw_step_bf16g(float *p, float *m, float *v, const uint16_t *g,
                         int64_t n, float lr, float beta1, float beta2,
                         float eps, float weight_decay, int64_t step,
                         float grad_coef, int adamw_mode) {
  const float bc1 = 1.0f - powf(beta1, (float)step);
  const float bc2 = 1.0f - powf(beta2, (float)step);
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t u = ((uint32_t)g[i]) << 16;
    float gf;
    memcpy(&gf, &u, 4);
    float gi = gf * grad_coef;
    if (!adamw_mode && weight_decay != 0.0f) gi += weight_decay * p[i];
    float mi = beta1 * m[i] + (1.0f - beta1) * gi;
    float vi = beta2 * v[i] + (1.0f - beta2) * gi * gi;
    m[i] = mi;
    v[i] = vi;
    float upd = (mi * inv_bc1) / (sqrtf(vi * inv_bc2) + eps);
    if (adamw_mode && weight_decay != 0.0f) upd += weight_decay * p[i];
    p[i] -= lr * upd;
  }
}

/* fp32 -> bf16 with round-to-nearest-even: the device compute copy pushed
 * back after the host step (reference equivalent: the f32->f16 param-copy
 * kernel csrc/common/custom_cuda_kernel.cu). */
void ds_f32_to_bf16(const float *src, uint16_t *dst, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t u;
    memcpy(&u, &src[i], 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) { /* NaN: torch's vectorized cast writes 0xFFFF */
      dst[i] = (uint16_t)0xffffu;
    } else {
      uint32_t rounded = u + 0x7fffu + ((u >> 16) & 1u);
      dst[i] = (uint16_t)(rounded >> 16);
    }
  }
}

/* Host-side Adagrad (reference csrc/adagrad/cpu_adagrad.cpp). */
void ds_adagrad_step(float *p, float *acc, const float *g, int64_t n,
                     float lr, float eps, float weight_decay,
                     float grad_coef) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float gi = g[i] * grad_coef;
    if (weight_decay != 0.0f) gi += weight_decay * p[i];
    float ai = acc[i] + gi * gi;
    acc[i] = ai;
    p[i] -= lr * gi / (sqrtf(ai) + eps);
  }
}
