// Device helpers of the model kernels. float32 / bfloat16 loads and
// stores: every kernel computes in float32 and converts only where it
// reads or writes memory. The conversions go through the intrinsics,
// since PyTorch's build flags turn off the implicit bfloat16 conversions.
// Also the asynchronous copy to shared memory and 2^x that the attention
// kernels share.
#pragma once

#include <cstdint>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without staging in registers; !valid writes
// 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 2^x (ex2.approx: 2 ulp; subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
