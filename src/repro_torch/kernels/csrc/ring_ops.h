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
