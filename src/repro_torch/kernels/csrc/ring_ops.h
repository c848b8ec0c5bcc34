// Launchers for the replay-ring kernels in ring_ops.cu. Plain C++ types
// only, so binding.cpp (the one file that includes PyTorch's headers)
// and ring_ops.cu (which includes none) compile independently.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// data[(*ptr + i) % capacity - *window_start] = batch[i] for the rows of
// batch (n, feat) that land inside the window [*window_start,
// *window_start + rows_local). window_start == nullptr means 0.
void launch_ring_write(float* data, const float* batch, const int32_t* ptr,
                       const int32_t* window_start, int64_t n, int64_t feat,
                       int64_t capacity, int64_t rows_local,
                       cudaStream_t stream);

// out[j] = data[idx[j] - *window_start] for in-window indices, else a row
// of zeros. data is (rows_local, feat), idx (bsz,), out (bsz, feat).
void launch_ring_gather(float* out, const float* data, const int32_t* idx,
                        const int32_t* window_start, int64_t bsz,
                        int64_t feat, int64_t rows_local,
                        cudaStream_t stream);

// The row-at-a-time baselines (no window): data[(*ptr + i) mod rows] =
// batch[i] for the n <= rows rows of batch (n, feat), the slot taken
// mod rows as a floor, so a negative ptr wraps.
void launch_ring_write_rowloop(float* data, const float* batch,
                               const int32_t* ptr, int64_t n, int64_t feat,
                               int64_t rows, cudaStream_t stream);

// out[i] = data[j] for j = idx[i], taken as j + rows when negative and
// then clamped to [0, rows - 1] (rows >= 1): what the TPU kernel's
// unchecked row reads give.
void launch_ring_gather_rowloop(float* out, const float* data,
                                const int32_t* idx, int64_t bsz,
                                int64_t feat, int64_t rows,
                                cudaStream_t stream);
