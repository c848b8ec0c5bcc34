// Prioritized-replay kernels for Hopper (sm_90a): the fused Gumbel score
// + top-k selection of a PER batch, the re-prioritisation scatter, and
// the bare score pass.
//
// per_topk replaces the TPU kernel repro/kernels/replay_ops.py:per_topk
// (_per_topk_kernel); priority_scatter replaces
// repro/kernels/replay_ops.py:priority_scatter (_priority_scatter_kernel);
// per_scores replaces repro/kernels/replay_ops.py:per_scores
// (_per_scores_kernel).
//
// per_scores. The TPU kernel walks (1, blk) blocks of the priority vector
// on a grid, the tail padded; here one thread scores one row of a
// grid-stride loop and the ragged edge is a bound check. It reads two
// floats and writes one a row: 12 B, 3.1 MB at 262,144 rows, 0.94 us at
// 3.35 TB/s, below the cost of a launch, so a launch bounds it. The
// benchmark's global_topk arm runs it before a library top-k (the path
// per_topk replaced).
//
// per_topk. The TPU kernel streams blocks of the priority window on a
// sequential grid into one running (1, k) sorted buffer in VMEM. On a GPU
// the blocks run in parallel and in no order, so nothing carries over
// from one block to the next and that design does not translate. Here:
//   1. score and pack: each row's score, computed as the plain version
//      computes it, becomes a 64-bit key: the score's bits mapped so that
//      a higher score gives a smaller key, in the high half, and the row
//      in the low half. The keys are distinct, and ascending key order is
//      score descending with the lower row first among equal scores:
//      jax.lax.top_k's order. Lanes past the rows get the largest key.
//   2. sort each tile of 4096 keys with a bitonic sort in shared memory
//      (one block a tile) and keep its first min(k, 4096) keys;
//   3. merge the sorted lists pairwise, one launch a round, log2(tiles)
//      rounds: every key finds its rank in the partner list by binary
//      search and lands at its own position plus that rank, if below k;
//   4. unpack the first k keys into scores and global rows; a -inf score
//      carries IDX_SENTINEL (2**31 - 1), as in the TPU kernel.
// The result is exact for every k <= rows. Bound: it must read the two
// (rows,) float vectors and write k scores and k indices: at the training
// path's shapes (rows 262144, k 8192) 2.16 MB, 0.65 us at 3.35 TB/s, far
// below the cost of one launch; the kernels here launch 2 + log2(tiles)
// times (8 at those shapes) and re-read the kept keys in every merge
// round. Fewer launches (one persistent merge) are later work.
//
// To agree bit for bit with the plain PyTorch version, the score rounds
// exactly as PyTorch's separate kernels do: logf without fast math, and
// the product and the sum each rounded on their own (__fmul_rn and
// __fadd_rn, which nvcc does not contract into an FMA).
//
// priority_scatter. The TPU kernel loops over the k indices in order, so
// on a repeated index the last write wins, and which one wins matters:
// PER draws cycle over the live rows when the batch exceeds them, and
// each draw carries its own |TD error|. One block runs three ordered
// phases over an int32 owner slot per touched row: clear the owner, take
// atomicMax of the draw's position, then only the owner writes. Bound:
// it moves about 12 B a draw (index, value, the priority written): 98 KB
// at k = 8192, 0.03 us at 3.35 TB/s, again far below a launch.
//
// window_start is read from device memory, like the ring kernels'; no
// launch here waits on the host.

#include "per_ops.h"

#include <math.h>

namespace {

constexpr int kTileThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr int kScatterThreads = 1024;
constexpr int32_t kIdxSentinel = 0x7fffffff;
constexpr uint64_t kPadKey = ~0ull;

// The float's bits mapped to a uint32 whose ascending order is the
// float's ascending order (-0.0 taken as +0.0 first).
__device__ __forceinline__ uint32_t ordered_bits(float s) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The Gumbel-top-k score of one row, the one definition per_scores and
// per_topk share.
__device__ __forceinline__ float per_score(float p, float g, float alpha) {
  const float logp =
      p > 0.0f ? __fmul_rn(alpha, logf(fmaxf(p, 1e-12f))) : -INFINITY;
  return __fadd_rn(logp, g);
}

constexpr int kScoreThreads = 256;
constexpr int64_t kScoreMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kScoreThreads)
per_scores_kernel(float* __restrict__ out,
                  const float* __restrict__ priorities,
                  const float* __restrict__ gumbel, float alpha,
                  int64_t rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < rows; i += stride) {
    out[i] = per_score(priorities[i], gumbel[i], alpha);
  }
}

// Score, pack, sort one tile of kPerTopkTile keys in shared memory, and
// write its first `keep` keys to out[tile * keep ...].
__global__ void __launch_bounds__(kTileThreads)
score_sort_tile_kernel(const float* __restrict__ priorities,
                       const float* __restrict__ gumbel, float alpha,
                       int64_t rows, int64_t keep,
                       uint64_t* __restrict__ out) {
  __shared__ uint64_t keys[kPerTopkTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPerTopkTile;
  for (int i = threadIdx.x; i < kPerTopkTile; i += blockDim.x) {
    const int64_t row = base + i;
    uint64_t key = kPadKey;
    if (row < rows) {
      const float s = per_score(priorities[row], gumbel[row], alpha);
      key = (static_cast<uint64_t>(~ordered_bits(s)) << 32) |
            static_cast<uint32_t>(row);
    }
    keys[i] = key;
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int size = 2; size <= kPerTopkTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kPerTopkTile; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool ascending = (i & size) == 0;
          const uint64_t a = keys[i], b = keys[j];
          if ((a > b) == ascending) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  uint64_t* dst = out + static_cast<int64_t>(blockIdx.x) * keep;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) dst[i] = keys[i];
}

// Number of keys of a[0, n) below key (strict) or not above it.
__device__ __forceinline__ int64_t rank_in(const uint64_t* a, int64_t n,
                                           uint64_t key, bool inclusive) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const uint64_t v = a[mid];
    if (v < key || (inclusive && v == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge round: lists 2m and 2m + 1 of `len_in` sorted keys each
// become list m of `len_out` = min(k, 2 len_in) keys. A key of the even
// list counts the partner's keys below it, a key of the odd list those
// not above it, so even equal (padding) keys land on distinct slots.
__global__ void merge_round_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* __restrict__ out,
                                   int64_t lists_in, int64_t len_in,
                                   int64_t len_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= lists_in * len_in) return;
  const int64_t list = e / len_in;
  const int64_t pos = e - list * len_in;
  const uint64_t key = in[e];
  const bool odd = list & 1;
  const uint64_t* partner = in + (list ^ 1) * len_in;
  const int64_t dest = pos + rank_in(partner, len_in, key, odd);
  if (dest < len_out) out[(list >> 1) * len_out + dest] = key;
}

__global__ void unpack_kernel(const uint64_t* __restrict__ keys,
                              float* __restrict__ scores,
                              int32_t* __restrict__ idx,
                              const int32_t* __restrict__ window_start,
                              int64_t k) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= k) return;
  const uint64_t key = keys[j];
  const float s = from_ordered_bits(~static_cast<uint32_t>(key >> 32));
  const int32_t lo = window_start ? *window_start : 0;
  scores[j] = s;
  idx[j] = s == -INFINITY
               ? kIdxSentinel
               : static_cast<int32_t>(static_cast<uint32_t>(key)) + lo;
}

__global__ void __launch_bounds__(kScatterThreads)
priority_scatter_kernel(float* __restrict__ priorities,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ values,
                        const int32_t* __restrict__ window_start, int64_t k,
                        int64_t rows_local, int32_t* owner) {
  const int64_t lo = window_start ? *window_start : 0;
  // 1. clear the owner of every touched row
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    const int64_t d = static_cast<int64_t>(idx[i]) - lo;
    if (d >= 0 && d < rows_local) owner[d] = -1;
  }
  __syncthreads();
  // 2. the last draw of each row owns it
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    const int64_t d = static_cast<int64_t>(idx[i]) - lo;
    if (d >= 0 && d < rows_local) atomicMax(owner + d, static_cast<int>(i));
  }
  __syncthreads();
  // 3. only the owner writes (read past L1: the atomics live in L2)
  for (int64_t i = threadIdx.x; i < k; i += blockDim.x) {
    const int64_t d = static_cast<int64_t>(idx[i]) - lo;
    if (d >= 0 && d < rows_local && __ldcg(owner + d) == i) {
      priorities[d] = values[i];
    }
  }
}

int64_t tile_count(int64_t rows) {
  const int64_t tiles = (rows + kPerTopkTile - 1) / kPerTopkTile;
  int64_t pow2 = 1;
  while (pow2 < tiles) pow2 <<= 1;
  return pow2;
}

}  // namespace

int64_t per_topk_scratch_keys(int64_t rows, int64_t k) {
  const int64_t keep = k < kPerTopkTile ? k : kPerTopkTile;
  return 2 * tile_count(rows) * keep;
}

void launch_per_topk(float* out_scores, int32_t* out_idx,
                     const float* priorities, const float* gumbel,
                     const int32_t* window_start, float alpha, int64_t rows,
                     int64_t k, uint64_t* scratch, cudaStream_t stream) {
  int64_t lists = tile_count(rows);
  int64_t len = k < kPerTopkTile ? k : kPerTopkTile;
  uint64_t* in = scratch;
  uint64_t* out = scratch + lists * len;
  score_sort_tile_kernel<<<static_cast<unsigned>(lists), kTileThreads, 0,
                           stream>>>(priorities, gumbel, alpha, rows, len,
                                     in);
  while (lists > 1) {
    const int64_t len_out = 2 * len < k ? 2 * len : k;
    const int64_t n = lists * len;
    merge_round_kernel<<<static_cast<unsigned>(
                             (n + kMergeThreads - 1) / kMergeThreads),
                         kMergeThreads, 0, stream>>>(in, out, lists, len,
                                                     len_out);
    uint64_t* t = in;
    in = out;
    out = t;
    lists >>= 1;
    len = len_out;
  }
  unpack_kernel<<<static_cast<unsigned>((k + kMergeThreads - 1) /
                                        kMergeThreads),
                  kMergeThreads, 0, stream>>>(in, out_scores, out_idx,
                                              window_start, k);
}

void launch_per_scores(float* out, const float* priorities,
                       const float* gumbel, float alpha, int64_t rows,
                       cudaStream_t stream) {
  int64_t blocks = (rows + kScoreThreads - 1) / kScoreThreads;
  if (blocks > kScoreMaxBlocks) blocks = kScoreMaxBlocks;
  per_scores_kernel<<<static_cast<unsigned>(blocks), kScoreThreads, 0,
                      stream>>>(out, priorities, gumbel, alpha, rows);
}

void launch_priority_scatter(float* priorities, const int32_t* idx,
                             const float* values,
                             const int32_t* window_start, int64_t k,
                             int64_t rows_local, int32_t* owner,
                             cudaStream_t stream) {
  priority_scatter_kernel<<<1, kScatterThreads, 0, stream>>>(
      priorities, idx, values, window_start, k, rows_local, owner);
}
