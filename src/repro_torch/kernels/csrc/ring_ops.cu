// Replay-ring kernels for Hopper (sm_90a): the ring write and the uniform
// gather of the device-resident replay pool.
//
// ring_write replaces the TPU kernel repro/kernels/replay_ops.py:ring_write
// (_ring_write_kernel), ring_gather replaces
// repro/kernels/replay_ops.py:ring_gather (_ring_gather_kernel). The TPU
// versions walk the rows with a sequential grid, double-buffered VMEM
// blocks and DMA semaphores; none of that carries over. Here every block
// works independently on its own slice of rows.
//
// What bounds them: at the training path's shapes both move well under
// 1 MB per call. A round's ring write moves n = 512 rows of the six replay
// fields, 10 floats a row (~20 KB in, ~20 KB out); a gather of B = 8192
// rows over the same fields reads about 8192 * 10 * 4 B = 328 KB and
// writes the same. At 3.35 TB/s that is a few hundred nanoseconds, far
// below the few microseconds a launch costs and the host's time to enqueue
// one, so both are bound by the launch and the host, not by HBM
// bandwidth. So the write takes every field of a round in one launch:
// the fields' pointers and row widths travel in a table passed by value
// (RingFields, a __grid_constant__ parameter), blockIdx.y picks the field
// and blockIdx.x runs over its n * width elements. The gather still
// launches once per field.
//
// ptr and window_start are read from device memory inside the kernels, so
// a caller never synchronises with the host to learn where to write.
//
// ring_write_rowloop and ring_gather_rowloop replace the TPU kernels
// repro/kernels/replay_ops.py:ring_write_rowloop
// (_ring_write_rowloop_kernel) and :ring_gather_rowloop
// (_ring_gather_rowloop_kernel): the first, row-at-a-time ring kernels,
// which the repo keeps as the baseline the blocked kernels above are
// measured against. The TPU versions hold the whole pool in VMEM and
// copy one row per step of a sequential loop. The row-at-a-time write
// keeps its own index rule (no window, the slot taken mod rows as a
// floor) but is launch_ring_write on a one-field table with floor_mod
// set, so it no longer copies a row at a time: against ring_write it
// differs only in that rule and in taking one field a call. The gather
// stays naive: one thread
// copies one whole row, with no window, no blocking and no shared memory,
// so neighbouring threads touch addresses a row apart and the copies do
// not coalesce. Both move what the kernels above move (the rows, the
// indices), so the same byte bound holds.
//
// The gather has no bounds check in the TPU kernel, so an index outside
// the pool reads what the interpreter's dynamic slice gives: a negative
// index is taken from the end once, and the rest is clamped into the
// pool. The kernel applies the same rule, which keeps every read inside
// data.

#include "ring_ops.h"

namespace {

constexpr int kWriteThreads = 256;
constexpr int kGatherThreads = 128;
constexpr int kGatherRows = 64;  // rows a gather block copies
constexpr int kRowloopThreads = 128;

// One thread per (row, feature) element of field blockIdx.y, features
// fastest: neighbouring threads store to neighbouring addresses of a
// destination row, and the rows of a run that does not wrap are
// contiguous, so the stores coalesce. Blocks past a narrow field's
// elements return at once. The slot of row i is (*ptr + i) % capacity,
// as the TPU kernel's lax.rem takes it (the sign of the dividend), less
// *window_start; or, with kFloorMod (the row-at-a-time baseline: no
// window, capacity == rows_local), the same remainder taken as a floor.
template <bool kFloorMod>
__global__ void __launch_bounds__(kWriteThreads)
    ring_write_kernel(const __grid_constant__ RingFields fields,
                      const int32_t* __restrict__ ptr,
                      const int32_t* __restrict__ window_start, int64_t n,
                      int64_t capacity, int64_t rows_local) {
  const int64_t feat = fields.width[blockIdx.y];
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n * feat) return;
  const int64_t i = e / feat;
  const int64_t f = e - i * feat;
  int64_t dest = (static_cast<int64_t>(*ptr) + i) % capacity;
  if constexpr (kFloorMod) {
    if (dest < 0) dest += capacity;
  } else if (window_start) {
    dest -= *window_start;
  }
  if (dest >= 0 && dest < rows_local) {
    fields.data[blockIdx.y][dest * feat + f] = fields.batch[blockIdx.y][e];
  }
}

// Each block takes kGatherRows consecutive output rows: it loads their
// int32 indices once into shared memory, then its threads copy those whole
// rows element by element, features fastest, so the output stores of the
// block are one contiguous run.
__global__ void ring_gather_kernel(float* __restrict__ out,
                                   const float* __restrict__ data,
                                   const int32_t* __restrict__ idx,
                                   const int32_t* __restrict__ window_start,
                                   int64_t bsz, int64_t feat,
                                   int64_t rows_local) {
  __shared__ int64_t src[kGatherRows];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGatherRows;
  const int64_t rows = bsz - row0 < kGatherRows ? bsz - row0 : kGatherRows;
  const int64_t lo = window_start ? *window_start : 0;
  for (int64_t r = threadIdx.x; r < rows; r += blockDim.x) {
    const int64_t j = static_cast<int64_t>(idx[row0 + r]) - lo;
    src[r] = (j >= 0 && j < rows_local) ? j : -1;  // -1: outside, zeros
  }
  __syncthreads();
  float* dst = out + row0 * feat;
  for (int64_t e = threadIdx.x; e < rows * feat; e += blockDim.x) {
    const int64_t r = e / feat;
    const int64_t j = src[r];
    dst[e] = j >= 0 ? data[j * feat + (e - r * feat)] : 0.0f;
  }
}

__global__ void ring_gather_rowloop_kernel(float* __restrict__ out,
                                           const float* __restrict__ data,
                                           const int32_t* __restrict__ idx,
                                           int64_t bsz, int64_t feat,
                                           int64_t rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= bsz) return;
  int64_t j = idx[i];
  if (j < 0) j += rows;
  j = j < 0 ? 0 : (j >= rows ? rows - 1 : j);
  for (int64_t f = 0; f < feat; ++f) {
    out[i * feat + f] = data[j * feat + f];
  }
}

}  // namespace

void launch_ring_write(const RingFields& fields, int nfields,
                       const int32_t* ptr, const int32_t* window_start,
                       int64_t n, int64_t capacity, int64_t rows_local,
                       bool floor_mod, cudaStream_t stream) {
  int64_t widest = 0;
  for (int k = 0; k < nfields; ++k) {
    widest = fields.width[k] > widest ? fields.width[k] : widest;
  }
  const int64_t blocks = (n * widest + kWriteThreads - 1) / kWriteThreads;
  if (blocks == 0) return;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(nfields));
  if (floor_mod) {
    ring_write_kernel<true><<<grid, kWriteThreads, 0, stream>>>(
        fields, ptr, window_start, n, capacity, rows_local);
  } else {
    ring_write_kernel<false><<<grid, kWriteThreads, 0, stream>>>(
        fields, ptr, window_start, n, capacity, rows_local);
  }
}

void launch_ring_gather(float* out, const float* data, const int32_t* idx,
                        const int32_t* window_start, int64_t bsz,
                        int64_t feat, int64_t rows_local,
                        cudaStream_t stream) {
  const int64_t blocks = (bsz + kGatherRows - 1) / kGatherRows;
  ring_gather_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       stream>>>(out, data, idx, window_start, bsz, feat,
                                 rows_local);
}

void launch_ring_gather_rowloop(float* out, const float* data,
                                const int32_t* idx, int64_t bsz,
                                int64_t feat, int64_t rows,
                                cudaStream_t stream) {
  const int64_t blocks = (bsz + kRowloopThreads - 1) / kRowloopThreads;
  ring_gather_rowloop_kernel<<<static_cast<unsigned>(blocks),
                               kRowloopThreads, 0, stream>>>(
      out, data, idx, bsz, feat, rows);
}
