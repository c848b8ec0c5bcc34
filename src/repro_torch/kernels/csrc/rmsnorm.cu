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

constexpr int kBwdRows = 32;     // rows a block of the backward
constexpr int kBwdThreads = 256;

// dx for kBwdRows rows, and the block's partial dw (dw_part[blockIdx.x,
// :]).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_rows_kernel(T* __restrict__ dx, float* __restrict__ dw_part,
                            const T* __restrict__ x,
                            const T* __restrict__ dy,
                            const float* __restrict__ w, int64_t rows,
                            int dim, float eps) {
  __shared__ float r_s[kBwdRows];   // r of each row
  __shared__ float c_s[kBwdRows];   // r^3 mean(g x) of each row
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBwdRows;
  const int n = static_cast<int>(rows - row0 < kBwdRows ? rows - row0
                                                        : kBwdRows);
  for (int i = warp; i < n; i += kBwdThreads / 32) {
    const T* xr = x + (row0 + i) * dim;
    const T* dyr = dy + (row0 + i) * dim;
    float ss = 0.0f, gx = 0.0f;
    for (int j = lane; j < dim; j += 32) {
      const float xv = to_f32(xr[j]);
      ss += xv * xv;
      gx += to_f32(dyr[j]) * w[j] * xv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0) {
      const float r = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);
      r_s[i] = r;
      c_s[i] = r * r * r * gx / static_cast<float>(dim);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < dim; j += kBwdThreads) {
    const float wj = w[j];
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int64_t e = (row0 + i) * dim + j;
      const float xv = to_f32(x[e]);
      const float dyv = to_f32(dy[e]);
      dx[e] = from_f32<T>(r_s[i] * dyv * wj - xv * c_s[i]);
      acc += dyv * xv * r_s[i];
    }
    dw_part[static_cast<int64_t>(blockIdx.x) * dim + j] = acc;
  }
}

// dw[j] = the sum of dw_part[:, j] over the blocks, in block order.
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_dw_kernel(float* __restrict__ dw,
                          const float* __restrict__ dw_part, int parts,
                          int dim) {
  const int j = blockIdx.x * kBwdThreads + threadIdx.x;
  if (j >= dim) return;
  float acc = 0.0f;
  for (int b = 0; b < parts; ++b)
    acc += dw_part[static_cast<int64_t>(b) * dim + j];
  dw[j] = acc;
}

template <typename T>
cudaError_t launch_bwd(void* dx, float* dw, float* dw_part, const void* x,
                       const void* dy, const float* w, int64_t rows,
                       int64_t dim, float eps, cudaStream_t stream) {
  const int64_t parts = rmsnorm_bwd_parts(rows);
  if (parts > 0) {
    rmsnorm_bwd_rows_kernel<T>
        <<<static_cast<unsigned>(parts), kBwdThreads, 0, stream>>>(
            static_cast<T*>(dx), dw_part, static_cast<const T*>(x),
            static_cast<const T*>(dy), w, rows, static_cast<int>(dim), eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_dw_kernel<<<static_cast<unsigned>((dim + kBwdThreads - 1) /
                                                kBwdThreads),
                          kBwdThreads, 0, stream>>>(
      dw, dw_part, static_cast<int>(parts), static_cast<int>(dim));
  return cudaGetLastError();
}

}  // namespace

int64_t rmsnorm_bwd_parts(int64_t rows) {
  return (rows + kBwdRows - 1) / kBwdRows;
}

cudaError_t launch_rmsnorm_bwd(void* dx, float* dw, float* dw_part,
                               const void* x, const void* dy, const float* w,
                               int64_t rows, int64_t dim, float eps,
                               bool bf16, cudaStream_t stream) {
  if (dim == 0) return cudaSuccess;
  return bf16 ? launch_bwd<__nv_bfloat16>(dx, dw, dw_part, x, dy, w, rows,
                                          dim, eps, stream)
              : launch_bwd<float>(dx, dw, dw_part, x, dy, w, rows, dim, eps,
                                  stream);
}

cudaError_t launch_rmsnorm(void* out, const void* x, const float* w,
                           int64_t rows, int64_t dim, float eps, bool bf16,
                           cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  return bf16 ? launch<__nv_bfloat16>(out, x, w, rows, dim, eps, stream)
              : launch<float>(out, x, w, rows, dim, eps, stream);
}
