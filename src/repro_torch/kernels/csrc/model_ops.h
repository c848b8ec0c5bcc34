// Launchers for the LM model kernels in rmsnorm.cu, flash_attention.cu,
// decode_attention.cu and ssd_scan.cu. Plain C++ types only, like
// ring_ops.h, so that binding.cpp and the .cu files compile independently.
// Tensors are float32 or bfloat16 (`bf16` says which); every launcher
// returns the CUDA error of its launch (cudaSuccess when the kernels were
// queued).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Largest head dimension the attention kernels take.
constexpr int kMaxHeadDim = 128;
// Largest number of query heads that share one KV head in decode_attention.
constexpr int kMaxDecodeGroup = 16;

// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, in float32, cast
// to x's type. x and out are (rows, dim), w is (dim,) float32.
cudaError_t launch_rmsnorm(void* out, const void* x, const float* w,
                           int64_t rows, int64_t dim, float eps, bool bf16,
                           cudaStream_t stream);

// Online-softmax GQA attention: q (B, Sq, H, d), k and v (B, Sk, KV, d),
// out like q. Query row i sits at position Sk - Sq + i; key j attends if
// j < Sk, and (causal) j <= its position, and (has_window) position - j <
// window. Query head h reads KV head h / (H / KV). Requires d <= 128.
cudaError_t launch_flash_attention(void* out, const void* q, const void* k,
                                   const void* v, int64_t B, int64_t Sq,
                                   int64_t Sk, int64_t H, int64_t KV,
                                   int64_t d, float scale, bool causal,
                                   bool has_window, int64_t window, bool bf16,
                                   cudaStream_t stream);

// Keys of the cache one block of decode_attention's first pass covers.
constexpr int64_t kDecodeSplit = 256;

// One query per (b, h) against a cache: q (B, H, d), k_cache and v_cache
// (B, S, KV, d), out like q; cache slots [0, min(*valid_len, S)) attend.
// The first pass writes, per (b, kv head, split of kDecodeSplit slots),
// each group head's running max and sum (part_ml, (B, KV, splits, G, 2))
// and unnormalised output (part_acc, (B, KV, splits, G, d)), all float32;
// the second combines the splits. Requires d <= 128 and H / KV <= 16.
cudaError_t launch_decode_attention(void* out, const void* q,
                                    const void* k_cache, const void* v_cache,
                                    const int32_t* valid_len, float* part_acc,
                                    float* part_ml, int64_t B, int64_t S,
                                    int64_t H, int64_t KV, int64_t d,
                                    float scale, bool bf16,
                                    cudaStream_t stream);

// Largest chunk length, and largest head dimension P and state size N, of
// ssd_scan.
constexpr int kMaxSsdChunk = 256;
constexpr int kMaxSsdDim = 128;

// Mamba-2 SSD chunked scan, float32 math: x (B, S, H, P) pre-scaled by dt,
// dtA (B, S, H) float32, B_ and C_ (B, S, H, N) like x; y like x and
// final_state (B, H, P, N) like x. Chunks of L rows, S % L == 0; the state
// starts at zero. Requires L <= kMaxSsdChunk, P and N <= kMaxSsdDim.
cudaError_t launch_ssd_scan(void* y, void* final_state, const void* x,
                            const float* dtA, const void* B_, const void* C_,
                            int64_t B, int64_t S, int64_t H, int64_t P,
                            int64_t N, int64_t L, bool bf16,
                            cudaStream_t stream);
