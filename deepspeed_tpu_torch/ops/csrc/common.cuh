// Shared helpers for the port's kernels: a plain C interface (loaded through
// ctypes) and the error string of a cudaGetLastError() code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DS_EXPORT extern "C" __attribute__((visibility("default")))

DS_EXPORT const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Same finite mask value as the TPU kernels: a masked score never makes
// exp(s - m) a NaN, and masked probabilities are zeroed explicitly.
#define DS_MASK_VALUE (-0.7f * 3.402823466e38f)
