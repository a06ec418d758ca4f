// Helpers shared by the port's CUDA kernels: element conversions and the
// dtype codes the C entry points take from the Python wrappers
// (coati_tpu_torch/ops/kernels/build.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coati {

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// large-negative instead of -inf: keeps the online softmax NaN-free
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

}  // namespace coati
