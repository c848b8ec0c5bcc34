// Launchers for the prioritized-replay kernels in per_ops.cu. Plain C++
// types only, like ring_ops.h, so that binding.cpp and per_ops.cu compile
// independently.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// uint64 keys of scratch per_topk needs for `rows` candidates and `k`
// winners: k winners and up to `rows` keys of the k-th key's bin.
int64_t per_topk_scratch_keys(int64_t rows, int64_t k);

// uint32 words of per_topk's state: zero when a call starts, and left
// zero by every call. The caller keeps one per stream that calls it and
// zeroes it once when it makes it.
int64_t per_topk_state_words();

// out[i] = alpha * log(max(p[i], 1e-12)) + g[i] where p[i] > 0, else
// -inf: the Gumbel-top-k sampling score of every row, as per_topk scores
// them (one shared device helper).
void launch_per_scores(float* out, const float* priorities,
                       const float* gumbel, float alpha, int64_t rows,
                       cudaStream_t stream);

// The k best Gumbel scores alpha * log(max(p, 1e-12)) + g (-inf where
// p == 0) over the rows of the window, sorted by descending score, the
// lower row first among equal scores; out_idx holds the global row
// (row + *window_start) or 0x7fffffff where the score is -inf.
// window_start == nullptr means 0. Requires 1 <= k <= rows < 2**31 - 1.
// Three launches, spread over `sms` blocks (the card's SM count); returns
// the first launch error.
cudaError_t launch_per_topk(float* out_scores, int32_t* out_idx,
                            const float* priorities, const float* gumbel,
                            const int32_t* window_start, float alpha,
                            int64_t rows, int64_t k, uint64_t* scratch,
                            uint32_t* state, int sms, cudaStream_t stream);

// priorities[idx[i] - *window_start] = values[i] for the in-window
// indices; where an index repeats, the write of the largest i wins. The
// rows are spread over about one block an SM (`sms`, the card's count).
void launch_priority_scatter(float* priorities, const int32_t* idx,
                             const float* values,
                             const int32_t* window_start, int64_t k,
                             int64_t rows_local, int sms,
                             cudaStream_t stream);
