// Launchers for the replay-ring kernels in ring_ops.cu. Plain C++ types
// only, so binding.cpp (the one file that includes PyTorch's headers)
// and ring_ops.cu (which includes none) compile independently.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// The fields of one ring write: each field k is a (rows_local,
// width[k]) float32 pool data[k] and an (n, width[k]) batch batch[k].
// Passed to the kernel by value, so a launch takes up to kMaxRingFields
// fields.
constexpr int kMaxRingFields = 8;
struct RingFields {
  float* data[kMaxRingFields];
  const float* batch[kMaxRingFields];
  int64_t width[kMaxRingFields];
};

// For each of the nfields fields, data[(*ptr + i) % capacity -
// *window_start] = batch[i] for the n rows of batch that land inside the
// window [*window_start, *window_start + rows_local), in one launch.
// window_start == nullptr means 0. With floor_mod (the row-at-a-time
// baseline: no window, capacity == rows_local) the slot is taken mod
// capacity as a floor, so a negative ptr wraps.
void launch_ring_write(const RingFields& fields, int nfields,
                       const int32_t* ptr, const int32_t* window_start,
                       int64_t n, int64_t capacity, int64_t rows_local,
                       bool floor_mod, cudaStream_t stream);

// The fields of one ring gather: each field k is a (rows_local,
// width[k]) float32 pool data[k] read into a (bsz, width[k]) out[k].
// Passed to the kernel by value, as RingFields is.
struct GatherFields {
  const float* data[kMaxRingFields];
  float* out[kMaxRingFields];
  int64_t width[kMaxRingFields];
};

// For each of the nfields fields, out[j] = data[idx[j] - *window_start]
// for in-window indices, else a row of zeros, in one launch.
// window_start == nullptr means 0. With clamp (the row-at-a-time
// baseline's rule: no window, rows_local >= 1) a negative index is taken
// from the end once and the rest clamped to [0, rows_local - 1]: what
// the TPU kernel's unchecked row reads give.
void launch_ring_gather(const GatherFields& fields, int nfields,
                        const int32_t* idx, const int32_t* window_start,
                        int64_t bsz, int64_t rows_local, bool clamp,
                        cudaStream_t stream);
