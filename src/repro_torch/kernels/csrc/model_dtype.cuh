// float32 / bfloat16 loads and stores for the model kernels: every kernel
// computes in float32 and converts only where it reads or writes memory.
// The conversions go through the intrinsics, since PyTorch's build flags
// turn off the implicit bfloat16 conversions.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// Round to nearest even, as PyTorch's and XLA's casts do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The finite "minus infinity" of the reference kernels: a row whose keys
// are all masked keeps a finite running max, so max - max is 0, not NaN.
constexpr float kNegInf = -1e30f;
