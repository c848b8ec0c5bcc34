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
// bandwidth. So each takes every field of a round (the write) or of an
// update (the gather) in one launch: the fields' pointers and row widths
// travel in a table passed by value (RingFields, GatherFields: a
// __grid_constant__ parameter), and blockIdx.y picks the field.
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
// copy one row per step of a sequential loop. Each keeps its own index
// rule but runs the blocked kernel on a one-field table with that rule's
// template flag, so neither copies a row at a time any more: against
// ring_write and ring_gather they differ only in the index rule and in
// taking one field a call. The write's rule: no window, the slot taken
// mod rows as a floor. The gather's: the TPU kernel has no bounds check,
// so an index outside the pool reads what the interpreter's dynamic slice
// gives; a negative index is taken from the end once, and the rest is
// clamped into the pool. The kernel applies the same rule, which keeps
// every read inside data.

#include "ring_ops.h"

namespace {

constexpr int kWriteThreads = 256;
constexpr int kGatherThreads = 128;
constexpr int kGatherRows = 128;  // rows a gather block copies
static_assert(kGatherThreads >= kGatherRows, "one index load a thread");

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

// Block (x, y) copies kGatherRows consecutive output rows of field y. Its
// threads load those rows' int32 indices once into shared memory, one a
// thread, each turned into a source row (in 64 bits, so no index
// overflows): less *window_start, -1 outside the window (a row of zeros);
// or, with kClamp, taken from the end once when negative and clamped into
// the pool. Then they copy the rows element by element, features
// fastest, so the block's stores are one contiguous run. Index is int32_t
// where every offset into a field fits in it (the launcher checks), so
// the per-element divide is a 32-bit one.
template <typename Index, bool kClamp>
__global__ void __launch_bounds__(kGatherThreads)
    ring_gather_kernel(const __grid_constant__ GatherFields fields,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ window_start,
                       int64_t bsz, int64_t rows_local) {
  __shared__ Index src[kGatherRows];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGatherRows;
  const int rows = bsz - row0 < kGatherRows ? static_cast<int>(bsz - row0)
                                            : kGatherRows;
  if (static_cast<int>(threadIdx.x) < rows) {
    int64_t j = idx[row0 + threadIdx.x];
    if constexpr (kClamp) {
      if (j < 0) j += rows_local;
      j = j < 0 ? 0 : (j >= rows_local ? rows_local - 1 : j);
    } else {
      if (window_start) j -= *window_start;
      if (j < 0 || j >= rows_local) j = -1;
    }
    src[threadIdx.x] = static_cast<Index>(j);
  }
  __syncthreads();
  const Index feat = static_cast<Index>(fields.width[blockIdx.y]);
  const float* __restrict__ data = fields.data[blockIdx.y];
  float* __restrict__ dst =
      fields.out[blockIdx.y] + static_cast<Index>(row0) * feat;
  const Index elems = static_cast<Index>(rows) * feat;
  for (Index e = threadIdx.x; e < elems; e += kGatherThreads) {
    const Index r = e / feat;
    const Index j = src[r];
    dst[e] = j >= 0 ? data[j * feat + (e - r * feat)] : 0.0f;
  }
}

template <typename Index>
void gather_with_index(const dim3 grid, const GatherFields& fields,
                       const int32_t* idx, const int32_t* window_start,
                       int64_t bsz, int64_t rows_local, bool clamp,
                       cudaStream_t stream) {
  if (clamp) {
    ring_gather_kernel<Index, true><<<grid, kGatherThreads, 0, stream>>>(
        fields, idx, window_start, bsz, rows_local);
  } else {
    ring_gather_kernel<Index, false><<<grid, kGatherThreads, 0, stream>>>(
        fields, idx, window_start, bsz, rows_local);
  }
}

int64_t widest_field(const int64_t* width, int nfields) {
  int64_t widest = 0;
  for (int k = 0; k < nfields; ++k) {
    widest = width[k] > widest ? width[k] : widest;
  }
  return widest;
}

}  // namespace

void launch_ring_write(const RingFields& fields, int nfields,
                       const int32_t* ptr, const int32_t* window_start,
                       int64_t n, int64_t capacity, int64_t rows_local,
                       bool floor_mod, cudaStream_t stream) {
  const int64_t widest = widest_field(fields.width, nfields);
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

void launch_ring_gather(const GatherFields& fields, int nfields,
                        const int32_t* idx, const int32_t* window_start,
                        int64_t bsz, int64_t rows_local, bool clamp,
                        cudaStream_t stream) {
  const int64_t blocks = (bsz + kGatherRows - 1) / kGatherRows;
  if (blocks == 0) return;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(nfields));
  // the largest offset into a field, and the loop's last step past it
  const int64_t span = (bsz > rows_local ? bsz : rows_local) *
                       widest_field(fields.width, nfields);
  if (span < (int64_t{1} << 31) - kGatherThreads) {
    gather_with_index<int32_t>(grid, fields, idx, window_start, bsz,
                               rows_local, clamp, stream);
  } else {
    gather_with_index<int64_t>(grid, fields, idx, window_start, bsz,
                               rows_local, clamp, stream);
  }
}
