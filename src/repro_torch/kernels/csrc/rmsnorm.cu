// RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * w per
// row, in float32, cast back to x's type.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel), which walks (block_rows, D) VMEM tiles with a grid
// over row blocks. Here one warp owns one row: its lanes stride over the
// row (neighbouring lanes on neighbouring addresses), sum the squares in
// float32, reduce with shuffles, then read the row again (from L1/L2) to
// scale it. No shared memory and no block-wide barrier.
//
// What bounds it: bytes. Each element is read once from device memory and
// written once, plus the float32 weight: at the prefill shape (8192 rows of
// 896 bf16) that is ~29 MB, ~9 us at 3.35 TB/s; a decode step's 8 rows
// are ~30 KB and the launch is the cost.

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(T* __restrict__ out, const T* __restrict__ x,
                   const float* __restrict__ w, int64_t rows, int dim,
                   float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * dim;
  float ss = 0.0f;
  for (int i = lane; i < dim; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // mean, then a correctly rounded 1 / sqrt (the reference's rsqrt)
  const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
  T* orow = out + row * dim;
  for (int i = lane; i < dim; i += 32)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * w[i]);
}

template <typename T>
cudaError_t launch(void* out, const void* x, const float* w, int64_t rows,
                   int64_t dim, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(x), w, rows,
      static_cast<int>(dim), eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_rmsnorm(void* out, const void* x, const float* w,
                           int64_t rows, int64_t dim, float eps, bool bf16,
                           cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  return bf16 ? launch<__nv_bfloat16>(out, x, w, rows, dim, eps, stream)
              : launch<float>(out, x, w, rows, dim, eps, stream);
}
