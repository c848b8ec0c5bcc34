// Launchers for the LM model kernels in rmsnorm.cu, rope.cu,
// flash_attention.cu, decode_attention.cu, ssd_scan.cu and
// ssd_scan_bwd.cu. Plain C++ types
// only, like ring_ops.h, so that binding.cpp and the .cu files compile
// independently.
// Tensors are float32 or bfloat16 (`bf16` says which); every launcher
// returns the CUDA error of its launch (cudaSuccess when the kernels were
// queued).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Largest head dimension the attention kernels take (paligemma-3b's 256).
constexpr int kMaxHeadDim = 256;
// Largest number of query heads that share one KV head in decode_attention.
constexpr int kMaxDecodeGroup = 16;

// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, in float32, cast
// to x's type. x and out are (rows, dim), w is (dim,) float32.
cudaError_t launch_rmsnorm(void* out, const void* x, const float* w,
                           int64_t rows, int64_t dim, float eps, bool bf16,
                           cudaStream_t stream);

// RMSNorm's backward, for dy like x: dx like x, dw (dim,) float32 summed
// over the rows. dw_part is float32 scratch of rmsnorm_bwd_parts(rows)
// rows of dim: the partial sums of blocks of rows, which a second launch
// adds in order (no atomics: the same bits every run).
int64_t rmsnorm_bwd_parts(int64_t rows);
cudaError_t launch_rmsnorm_bwd(void* dx, float* dw, float* dw_part,
                               const void* x, const void* dy, const float* w,
                               int64_t rows, int64_t dim, float eps,
                               bool bf16, cudaStream_t stream);

// Rotary position embedding, the half-split layout: q (B, Sq, H, d) at
// the positions pos_q (Sq,) into qo, and, when k is not null, k (B, Sk, KV,
// d) at pos_k (Sk,) into ko; float32 math, each product, sum and
// difference rounded on its own, then once to the input's type. inverse
// negates the sines (the backward). Positions are int64 (pos64) or int32.
// Requires d % 16 == 0 and 16-byte aligned rows.
cudaError_t launch_rope(void* qo, void* ko, const void* q, const void* k,
                        const void* pos_q, const void* pos_k, bool pos64,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                        int64_t KV, int64_t d, float theta, bool inverse,
                        bool bf16, cudaStream_t stream);

// Online-softmax GQA attention: q (B, Sq, H, d), k and v (B, Sk, KV, d),
// out like q. Query row i sits at position Sk - Sq + i; key j attends if
// j < Sk, and (causal) j <= its position or j < prefix_len, and
// (has_window) position - j < window. Query head h reads KV head h / (H /
// KV). Requires d <= kMaxHeadDim and 0 <= prefix_len <= Sk. bf16 runs on
// the tensor cores, float32 on a SIMT kernel. lse, when not null, takes
// each row's log-sum-exp of its scaled scores, (B, H, Sq) float32: -inf
// for a row that sees no key.
cudaError_t launch_flash_attention(void* out, float* lse, const void* q,
                                   const void* k, const void* v, int64_t B,
                                   int64_t Sq, int64_t Sk, int64_t H,
                                   int64_t KV, int64_t d, float scale,
                                   bool causal, int64_t prefix_len,
                                   bool has_window, int64_t window,
                                   bool bf16, cudaStream_t stream);

// The backward of launch_flash_attention under the same masks: given q,
// k, v, the forward's out and lse, and dout (like out), writes dq (like
// q), dk and dv (like k; each summed over the H / KV query heads of its
// KV head), all float32 math. delta is float32 scratch (B, H, Sq) for
// rowsum(dout * out). Three launches, no atomics: delta; a key-tile
// kernel for dk and dv; a query-tile kernel for dq.
cudaError_t launch_flash_attention_bwd(
    void* dq, void* dk, void* dv, float* delta, const void* q,
    const void* k, const void* v, const void* out, const float* lse,
    const void* dout, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
    int64_t KV, int64_t d, float scale, bool causal, int64_t prefix_len,
    bool has_window, int64_t window, bool bf16, cudaStream_t stream);

// Query heads one block of decode_attention's first pass scores; a
// larger group (G up to kMaxDecodeGroup) runs in chunks of this many.
constexpr int kDecodeHeadChunk = 8;
// A split of the cache is a multiple of this many slots.
constexpr int64_t kDecodeSplitAlign = 16;

// Blocks of decode_attention's first pass an SM holds at once: a block
// takes one head (G 1) or a chunk of kDecodeHeadChunk; four of one head,
// whose 48 KB rings of shared memory bound them, or three of a chunk,
// whose registers (q and the output of eight heads) do.
__host__ __device__ constexpr int decode_blocks_per_sm(int heads) {
  return heads == 1 ? 4 : 3;
}

// Cache slots one block of decode_attention's first pass covers: the
// cache is cut into as many splits as fill one wave of the blocks the
// SMs hold at once (a split is B * KV * head chunks blocks), but never
// fewer than one, each a multiple of kDecodeSplitAlign slots (the last
// may be shorter). The binding sizes the split workspaces by it and
// hands it to the launcher, so both see the same splits.
inline int64_t decode_split_len(int64_t B, int64_t S, int64_t KV, int64_t G,
                                int64_t sms) {
  const int64_t blocks = B * KV * ((G + kDecodeHeadChunk - 1) /
                                   kDecodeHeadChunk);
  const int64_t per_sm = decode_blocks_per_sm(G == 1 ? 1 : kDecodeHeadChunk);
  int64_t splits = per_sm * sms / blocks;
  if (splits < 1) splits = 1;
  const int64_t len = (S + splits - 1) / splits;
  return (len + kDecodeSplitAlign - 1) / kDecodeSplitAlign *
         kDecodeSplitAlign;
}

// One query per (b, h) against a cache: q (B, H, d), k_cache and v_cache
// (B, S, KV, d), out like q; cache slots [0, min(*valid_len, S)) attend.
// The first pass writes, per (b, kv head, split of split_len slots), each
// group head's running max (in log2 units: scores times scale log2 e) and
// sum (part_ml, (B, KV, splits, G, 2)) and unnormalised output (part_acc,
// (B, KV, splits, G, d)), all float32; the second combines the splits.
// Requires d <= kMaxHeadDim and H / KV <= 16.
cudaError_t launch_decode_attention(void* out, const void* q,
                                    const void* k_cache, const void* v_cache,
                                    const int32_t* valid_len, float* part_acc,
                                    float* part_ml, int64_t B, int64_t S,
                                    int64_t H, int64_t KV, int64_t d,
                                    int64_t split_len, float scale, bool bf16,
                                    cudaStream_t stream);

// Largest chunk length, and largest head dimension P and state size N, of
// ssd_scan.
constexpr int kMaxSsdChunk = 256;
constexpr int kMaxSsdDim = 128;

// Mamba-2 SSD chunked scan, float32 math: x (B, S, H, P) pre-scaled by dt,
// dtA (B, S, H) float32, B_ and C_ (B, S, H, N) like x; y like x and
// final_state (B, H, P, N) like x. Chunks of L rows, S % L == 0; the state
// starts at initial_state ((B, H, P, N) float32) or, when it is null, at
// zero. Scratch, float32: acum (B, H, S) takes each chunk's cumulative sum
// of dtA, states (B, H, S / L, P, N) each chunk's own state contribution
// and then the state it starts from (which the backward reads). Three
// kernels: the chunk states, the state recurrence, y. Requires L <=
// kMaxSsdChunk, P and N <= kMaxSsdDim.
cudaError_t launch_ssd_scan(void* y, void* final_state, const void* x,
                            const float* dtA, const void* B_, const void* C_,
                            const float* initial_state, float* acum,
                            float* states, int64_t B, int64_t S, int64_t H,
                            int64_t P, int64_t N, int64_t L, bool bf16,
                            cudaStream_t stream);

// The backward of launch_ssd_scan: its operands, the float32 states each
// chunk starts from (its `states` scratch after the call), dy like x and
// dfinal ((B, H, P, N) float32, or null for zero). Writes dx, dB and dC
// like x (dB and dC per head), ddtA (B, S, H) float32 and dinitial (B,
// H, P, N) float32, the gradient of the initial state. Scratch, float32:
// acum (B, H, S), adj (B, H, S / L, P, N) (each chunk's own adjoint term,
// then the adjoint of the state it ends with), and drow, dcol, qrow (B,
// H, S) (the parts of the gradient of the cumulative sum). Five kernels,
// no atomics. The same limits as launch_ssd_scan.
cudaError_t launch_ssd_scan_bwd(void* dx, float* ddtA, void* dB, void* dC,
                                float* dinitial, const void* x,
                                const float* dtA, const void* B_,
                                const void* C_, const float* states,
                                const void* dy, const float* dfinal,
                                float* acum, float* adj, float* drow,
                                float* dcol, float* qrow, int64_t B,
                                int64_t S, int64_t H, int64_t P, int64_t N,
                                int64_t L, bool bf16, cudaStream_t stream);
