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
// on a grid, the tail padded; here one thread scores four rows, with
// float4 loads and stores where the three vectors are 16-byte aligned
// (one row a thread where they are not), the grid covers the rows in one
// pass and the ragged tail is a bound check. It reads two floats and
// writes one a row: 12 B, 3.1 MB at 262,144 rows, 0.94 us at 3.35 TB/s,
// below the cost of a launch, so the launch and the host bound it: the
// binding makes the output, and the Python wrapper only refuses a tensor
// off the card and a shape mismatch. The benchmark's global_topk arm runs
// it before a library top-k (the path per_topk replaced).
//
// per_topk. The TPU kernel streams blocks of the priority window on a
// sequential grid into one running (1, k) sorted buffer in VMEM. On a GPU
// the blocks run in parallel and in no order, so nothing carries over
// from one block to the next and that design does not translate. Each
// row's score, computed as the plain version computes it, becomes a
// 64-bit key: the score's bits mapped so that a higher score gives a
// smaller key, in the high half, and the row in the low half. The keys
// are distinct, and ascending key order is score descending with the
// lower row first among equal scores: jax.lax.top_k's order. The k
// smallest keys are the answer; a -inf score is no key at all, since its
// slot outputs (-inf, IDX_SENTINEL) whatever its row. Three launches:
//   1. count: a histogram of the keys' top 13 bits (8,192 bins), one per
//      block in shared memory, added into a global one; the block that
//      finishes last (an atomic ticket after a __threadfence) scans it,
//      finds the bin that holds the k-th key (the digit), and turns the
//      counts of the bins up to it into their first output slots;
//   2. place: every key of a bin below the digit is a winner and takes
//      the next slot of its bin (warp-aggregated atomic claims), so the
//      winners lie grouped by bin in bin order; the digit's keys go to a
//      candidate buffer, and the last block selects the ones that still
//      win with 8-bit digit histograms over the rest of the key (the
//      score's bits settle it in almost every call; the row's run only
//      while ties remain) and appends them;
//   3. sort: each winner's slot is its bin's first slot plus the number
//      of keys of its bin below its own (rank by counting, 16 lanes a
//      key over shared-memory tiles of the bin), unpacked into score and
//      global row; slots past the live keys get -inf and IDX_SENTINEL.
//      The last block leaves the state zeroed for the next call.
// Bound: the two (rows,) float vectors read and k scores and k indices
// written: at the training path's shapes (rows 262,144, k 8,192) 2.16 MB,
// 0.65 us at 3.35 TB/s. The window's 2 MB stays in the 50 MB L2 between
// the two passes over it. Comparisons: the sum over bins of their
// winners squared, about 7.6 M at those shapes (26 bins, at most 1,672
// keys; the digit's bin holds about 1,080 candidates) where one count
// over all k winners would take 67 M; at its worst (every row at one
// score) 67 M. Twelve bits would double that and fourteen halve it, but
// each bit doubles the histogram every count block clears and flushes.
//
// The histogram, the tickets and the candidate count live in a small
// state (TopkState) that is zero between calls: the binding keeps one
// per device and stream, zeroed when it is made, and every call leaves
// it zeroed, so no launch goes to clearing it.
//
// To agree bit for bit with the plain PyTorch version, the score rounds
// exactly as PyTorch's separate kernels do: logf without fast math, and
// the product and the sum each rounded on their own (__fmul_rn and
// __fadd_rn, which nvcc does not contract into an FMA).
//
// priority_scatter. The TPU kernel loops over the k indices in order, so
// on a repeated index the last write wins, and which one wins matters:
// PER draws cycle over the live rows when the batch exceeds them, and
// each draw carries its own |TD error|. Here the window's rows are cut
// into ranges, one block a range, about one block an SM (at most
// kScatterRows rows a block): each block reads every draw, keeps in
// shared memory the largest position of a draw on each of its rows
// (atomicMax, -1 for none), and then writes its rows that a draw
// touched, each from its last draw. A row belongs to exactly one block,
// so no block depends on another or on the order they run in, and no
// scratch lives in device memory. Bound: it moves about 12 B a draw
// (index, value, the priority written): 98 KB at k = 8192, 0.03 us at
// 3.35 TB/s, far below a launch; every block re-reads the k indices from
// L2 (4 MB at k 8192 and 131 blocks), which a launch also outlasts.
//
// window_start is read from device memory, like the ring kernels'; no
// launch here waits on the host.

#include "per_ops.h"

#include <math.h>

namespace {

constexpr int kScatterThreads = 512;
// Most rows a priority_scatter block owns (its table: 48 KB of shared
// memory, the most a block takes without opting in).
constexpr int64_t kScatterRows = 12288;
constexpr int kScatterBatch = 4;
constexpr int32_t kIdxSentinel = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

// per_topk: threads of a count or place block; the first digit's bits
// and bins; keys a sort block ranks, lanes a key, and keys it stages in
// shared memory at a time
constexpr int kTopkThreads = 1024;
constexpr int kDigitBits = 13;
constexpr int kBins = 1 << kDigitBits;
constexpr int kDigitShift = 64 - kDigitBits;
constexpr int kSortKeys = 16;
constexpr int kSortLanes = 16;
constexpr int kSortThreads = kSortKeys * kSortLanes;
constexpr int kSortTile = 4096;
constexpr int kSortBatch = 8;
// a place thread's class: a winner's bin, a candidate, or neither
constexpr uint32_t kCandidate = kBins;
constexpr uint32_t kNoClass = 0xffffffffu;
constexpr int kBinsPerThread = kBins / kTopkThreads;  // in the scan
static_assert(kBinsPerThread % 4 == 0, "a scan thread loads uint4s");

// Zero between calls but for the three words the count writes.
struct TopkState {
  uint32_t bins[kBins];  // counts, then first slots, then last slots
  uint32_t ticket[3];    // blocks done, one word a launch
  uint32_t candidates;   // keys in the digit's bin
  uint32_t digit;        // the k-th key's bin; kBins: every key wins
  uint32_t before;       // keys in the bins below the digit
  uint32_t winners;      // min(k, keys)
};

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

// The key's high half: a higher score gives a smaller word.
__device__ __forceinline__ uint32_t key_high(float s) {
  return ~ordered_bits(s);
}

constexpr uint32_t kNegInfHigh = 0xff800000u;  // key_high(-inf)

constexpr int kScoreThreads = 256;

// One row a thread, or with kVec four rows a thread as float4 and the
// ragged tail (rows % 4) one row a thread after them.
template <bool kVec>
__global__ void __launch_bounds__(kScoreThreads)
per_scores_kernel(float* __restrict__ out,
                  const float* __restrict__ priorities,
                  const float* __restrict__ gumbel, float alpha,
                  int64_t rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t quads = kVec ? rows >> 2 : 0;
  if (i < quads) {
    const float4 p = __ldg(reinterpret_cast<const float4*>(priorities) + i);
    const float4 g = __ldg(reinterpret_cast<const float4*>(gumbel) + i);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(per_score(p.x, g.x, alpha), per_score(p.y, g.y, alpha),
                    per_score(p.z, g.z, alpha), per_score(p.w, g.w, alpha));
    return;
  }
  const int64_t r = 4 * quads + (i - quads);
  if (r < rows) out[r] = per_score(priorities[r], gumbel[r], alpha);
}

// Exclusive prefix sum of v over the block's threads (a multiple of 32,
// at most 1024); total gets the block's sum. warp_sums holds 32 words.
__device__ uint32_t block_exclusive_sum(uint32_t v, uint32_t* warp_sums,
                                        uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[warps - 1];
  const uint32_t before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

// Whether this block is the last of the grid to get here: every thread's
// writes and atomics are fenced before the ticket, and the last block
// reads the others' through L2 (__ldcg) after it.
__device__ bool last_block(uint32_t* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Launch 1: the histogram of the keys' top kDigitBits bits. The last block
// finds the digit (the bin of the k-th key), writes the first slot of
// every bin up to it, and zeroes the bins above it.
__global__ void __launch_bounds__(kTopkThreads)
topk_count_kernel(const float* __restrict__ priorities,
                  const float* __restrict__ gumbel, float alpha,
                  int64_t rows, uint32_t k, TopkState* st) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[32];
  __shared__ uint32_t digit, before;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < rows; row += stride) {
    const uint32_t high = key_high(per_score(priorities[row], gumbel[row],
                                             alpha));
    if (high != kNegInfHigh) {
      atomicAdd(hist + (high >> (32 - kDigitBits)), 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (hist[i]) atomicAdd(st->bins + i, hist[i]);
  }
  if (!last_block(st->ticket)) return;

  // kBinsPerThread bins a thread, in order
  const uint32_t b0 = kBinsPerThread * threadIdx.x;
  uint32_t c[kBinsPerThread], sum = 0;
#pragma unroll
  for (int q = 0; q < kBinsPerThread / 4; ++q) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(st->bins + b0) + q);
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) sum += c[j];
  uint32_t keys;
  uint32_t s[kBinsPerThread + 1];   // each bin's first slot, then the end
  s[0] = block_exclusive_sum(sum, warp_sums, keys);
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) s[j + 1] = s[j] + c[j];
  if (threadIdx.x == 0 && keys <= k) {
    digit = kBins;   // every key wins
    before = keys;
  }
  if (keys > k) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      if (s[j] < k && k <= s[j + 1]) {
        digit = b0 + j;
        before = s[j];
      }
    }
  }
  __syncthreads();
  const uint32_t d = digit;
#pragma unroll
  for (int q = 0; q < kBinsPerThread / 4; ++q) {
    const uint32_t b = b0 + 4 * q;
    __stcg(reinterpret_cast<uint4*>(st->bins + b0) + q,
           make_uint4(b <= d ? s[4 * q] : 0u, b + 1 <= d ? s[4 * q + 1] : 0u,
                      b + 2 <= d ? s[4 * q + 2] : 0u,
                      b + 3 <= d ? s[4 * q + 3] : 0u));
  }
  if (threadIdx.x == 0) {
    st->digit = d;
    st->before = before;
    st->winners = keys < k ? keys : k;
    st->ticket[0] = 0;
  }
}

// The block's `need` smallest of the n candidate keys cand[] (distinct,
// all in the digit's bin), appended to out[] in any order: 8-bit digit
// histograms below the first digit, most significant first, narrow the
// wanted key (the need-th smallest) until every key left under the
// prefix wins; then every key at or below that threshold is taken.
__device__ void select_candidates(const uint64_t* cand, uint32_t n,
                                  uint32_t need, uint32_t digit,
                                  uint64_t* out) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t pick, pick_before, pick_count, taken;
  const int lane = threadIdx.x & 31;
  uint64_t threshold = ~0ull;
  if (need < n) {
    uint64_t prefix = static_cast<uint64_t>(digit) << kDigitShift;
    uint64_t mask = ~0ull << kDigitShift;
    uint32_t rank = need;  // the wanted key's rank under the prefix
    for (int shift = kDigitShift; ;) {
      const int width = shift < 8 ? shift : 8;
      shift -= width;
      const uint32_t dmask = (1u << width) - 1;
      for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
      __syncthreads();
#pragma unroll 4
      for (uint32_t i = threadIdx.x; i < n; i += blockDim.x) {
        const uint64_t x = __ldcg(cand + i);
        if ((x & mask) == prefix) {
          atomicAdd(hist + ((x >> shift) & dmask), 1u);
        }
      }
      __syncthreads();
      if (threadIdx.x < 32) {   // eight bins a lane
        uint32_t c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += c[j] = hist[8 * lane + j];
        uint32_t incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t y = __shfl_up_sync(kFullMask, incl, o);
          if (lane >= o) incl += y;
        }
        uint32_t at = incl - sum;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (at < rank && rank <= at + c[j]) {
            pick = 8 * lane + j;
            pick_before = at;
            pick_count = c[j];
          }
          at += c[j];
        }
      }
      __syncthreads();
      rank -= pick_before;
      prefix |= static_cast<uint64_t>(pick) << shift;
      mask |= static_cast<uint64_t>(dmask) << shift;
      if (pick_count == rank || shift == 0) {
        threshold = prefix | ((1ull << shift) - 1);
        break;
      }
    }
  }
  if (threadIdx.x == 0) taken = 0;
  __syncthreads();
  for (uint32_t i0 = 0; i0 < n; i0 += blockDim.x) {
    const uint32_t i = i0 + threadIdx.x;
    const uint64_t x = i < n ? __ldcg(cand + i) : ~0ull;
    const bool take = i < n && x <= threshold;
    const unsigned ballot = __ballot_sync(kFullMask, take);
    uint32_t base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&taken, __popc(ballot));
    base = __shfl_sync(kFullMask, base, 0);
    if (take) out[base + __popc(ballot & ((1u << lane) - 1))] = x;
  }
}

// Launch 2: each key of a bin below the digit takes the next slot of its
// bin; the digit's keys go to the candidate buffer. The last block
// appends the candidates that win after the bins' winners.
__global__ void __launch_bounds__(kTopkThreads)
topk_place_kernel(const float* __restrict__ priorities,
                  const float* __restrict__ gumbel, float alpha,
                  int64_t rows, uint32_t k, TopkState* st,
                  uint64_t* __restrict__ winners,
                  uint64_t* __restrict__ cand) {
  const uint32_t digit = st->digit;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // warp-uniform trips, so every lane reaches the ballot
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < rows; base += stride) {
    const int64_t row = base + threadIdx.x;
    uint32_t cls = kNoClass;
    uint64_t key = 0;
    if (row < rows) {
      const uint32_t high = key_high(per_score(priorities[row], gumbel[row],
                                               alpha));
      const uint32_t bin = high >> (32 - kDigitBits);
      if (high != kNegInfHigh && bin <= digit) {
        cls = bin < digit ? bin : kCandidate;
        key = (static_cast<uint64_t>(high) << 32) | static_cast<uint32_t>(row);
      }
    }
    const unsigned active = __ballot_sync(kFullMask, cls != kNoClass);
    if (cls != kNoClass) {
      // one atomic for the lanes of a warp that share a counter
      const unsigned peers = __match_any_sync(active, cls);
      const int leader = __ffs(peers) - 1;
      uint32_t slot = 0;
      if (lane == leader) {
        slot = atomicAdd(cls < kCandidate ? st->bins + cls : &st->candidates,
                         __popc(peers));
      }
      slot = __shfl_sync(peers, slot, leader) +
             __popc(peers & ((1u << lane) - 1));
      (cls < kCandidate ? winners : cand)[slot] = key;
    }
  }
  if (!last_block(st->ticket + 1)) return;
  const uint32_t n = __ldcg(&st->candidates);
  if (digit < kBins) {
    select_candidates(cand, n, k - st->before, digit,
                      winners + st->before);
  }
  if (threadIdx.x == 0) {
    st->candidates = 0;
    st->ticket[1] = 0;
  }
}

// Launch 3: kSortKeys winner slots a block, kSortLanes lanes a key. A
// winner of bin b lies in [end of bin b - 1, end of bin b) (the digit's
// bin ends at the winners' count); its output slot is that start plus
// the keys of the bin below it, counted over shared-memory tiles of the
// block's span. The last block zeroes the bins the call wrote.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_kernel(const uint64_t* __restrict__ winners, TopkState* st,
                 float* __restrict__ scores, int32_t* __restrict__ idx,
                 const int32_t* __restrict__ window_start, uint32_t k) {
  __shared__ uint64_t tile[kSortTile];
  __shared__ uint32_t span_lo, span_hi;
  const uint32_t w = st->winners, digit = st->digit;
  const int sub = threadIdx.x % kSortLanes;
  const uint32_t j = blockIdx.x * kSortKeys + threadIdx.x / kSortLanes;
  if (threadIdx.x == 0) {
    span_lo = 0xffffffffu;
    span_hi = 0;
  }
  __syncthreads();
  uint64_t x = 0;
  uint32_t lo = 0, hi = 0;
  if (j < w) {
    x = winners[j];
    const uint32_t bin = static_cast<uint32_t>(x >> kDigitShift);
    lo = bin ? st->bins[bin - 1] : 0;
    hi = bin == digit ? w : st->bins[bin];
    if (sub == 0) {
      atomicMin(&span_lo, lo);
      atomicMax(&span_hi, hi);
    }
  }
  __syncthreads();
  uint32_t below = 0;
  for (uint32_t t0 = span_lo; t0 < span_hi; t0 += kSortTile) {
    const uint32_t t1 = t0 + kSortTile < span_hi ? t0 + kSortTile : span_hi;
    // kSortBatch loads a thread in flight before their stores
    for (uint32_t i0 = t0 + threadIdx.x; i0 < t1;
         i0 += kSortBatch * blockDim.x) {
      uint64_t v[kSortBatch];
#pragma unroll
      for (int q = 0; q < kSortBatch; ++q) {
        const uint32_t i = i0 + q * blockDim.x;
        v[q] = i < t1 ? __ldg(winners + i) : 0;
      }
#pragma unroll
      for (int q = 0; q < kSortBatch; ++q) {
        const uint32_t i = i0 + q * blockDim.x;
        if (i < t1) tile[i - t0] = v[q];
      }
    }
    __syncthreads();
    const uint32_t a = lo > t0 ? lo : t0, e = hi < t1 ? hi : t1;
#pragma unroll 4
    for (uint32_t i = a + sub; i < e; i += kSortLanes) {
      below += tile[i - t0] < x;
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 1; o < kSortLanes; o <<= 1) {
    below += __shfl_xor_sync(kFullMask, below, o);
  }
  if (sub == 0 && j < k) {
    if (j < w) {
      const int32_t first = window_start ? *window_start : 0;
      scores[lo + below] = from_ordered_bits(~static_cast<uint32_t>(x >> 32));
      idx[lo + below] = static_cast<int32_t>(static_cast<uint32_t>(x)) + first;
    } else {
      scores[j] = -INFINITY;
      idx[j] = kIdxSentinel;
    }
  }
  if (!last_block(st->ticket + 2)) return;
  const uint32_t dirty = digit < kBins ? digit + 1 : kBins;
  for (uint32_t i = threadIdx.x; i < dirty; i += blockDim.x) st->bins[i] = 0;
  if (threadIdx.x == 0) st->ticket[2] = 0;
}

__global__ void __launch_bounds__(kScatterThreads)
priority_scatter_kernel(float* __restrict__ priorities,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ values,
                        const int32_t* __restrict__ window_start, int64_t k,
                        int64_t rows_local, int rows_per_block) {
  extern __shared__ int32_t last[];  // the last draw on each of its rows
  const int64_t lo = window_start ? *window_start : 0;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int n = rows_local - r0 < rows_per_block
                    ? static_cast<int>(rows_local - r0)
                    : rows_per_block;
  for (int r = threadIdx.x; r < n; r += blockDim.x) last[r] = -1;
  __syncthreads();
  // kScatterBatch draws a thread at a time: their loads are in flight
  // together, then their atomics
  for (int64_t i0 = threadIdx.x; i0 < k;
       i0 += kScatterBatch * static_cast<int64_t>(blockDim.x)) {
    int64_t r[kScatterBatch];
#pragma unroll
    for (int j = 0; j < kScatterBatch; ++j) {
      const int64_t i = i0 + j * static_cast<int64_t>(blockDim.x);
      r[j] = i < k ? static_cast<int64_t>(idx[i]) - lo - r0 : -1;
    }
#pragma unroll
    for (int j = 0; j < kScatterBatch; ++j) {
      if (r[j] >= 0 && r[j] < n) {
        atomicMax(last + r[j], static_cast<int>(i0 + j * blockDim.x));
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int i = last[r];
    if (i >= 0) priorities[r0 + r] = values[i];
  }
}

}  // namespace

int64_t per_topk_scratch_keys(int64_t rows, int64_t k) { return k + rows; }

int64_t per_topk_state_words() {
  return static_cast<int64_t>(sizeof(TopkState) / sizeof(uint32_t));
}

cudaError_t launch_per_topk(float* out_scores, int32_t* out_idx,
                            const float* priorities, const float* gumbel,
                            const int32_t* window_start, float alpha,
                            int64_t rows, int64_t k, uint64_t* scratch,
                            uint32_t* state, int sms, cudaStream_t stream) {
  TopkState* st = reinterpret_cast<TopkState*>(state);
  int64_t blocks = (rows + kTopkThreads - 1) / kTopkThreads;
  if (blocks > sms) blocks = sms;
  const uint32_t k32 = static_cast<uint32_t>(k);
  topk_count_kernel<<<static_cast<unsigned>(blocks), kTopkThreads, 0,
                      stream>>>(priorities, gumbel, alpha, rows, k32, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_place_kernel<<<static_cast<unsigned>(blocks), kTopkThreads, 0,
                      stream>>>(priorities, gumbel, alpha, rows, k32, st,
                                scratch, scratch + k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_sort_kernel<<<static_cast<unsigned>((k + kSortKeys - 1) / kSortKeys),
                     kSortThreads, 0, stream>>>(scratch, st, out_scores,
                                                out_idx, window_start, k32);
  return cudaGetLastError();
}

void launch_per_scores(float* out, const float* priorities,
                       const float* gumbel, float alpha, int64_t rows,
                       cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(priorities) |
                     reinterpret_cast<uintptr_t>(gumbel)) & 15) == 0;
  const int64_t threads = vec ? (rows >> 2) + (rows & 3) : rows;
  const unsigned blocks =
      static_cast<unsigned>((threads + kScoreThreads - 1) / kScoreThreads);
  if (vec) {
    per_scores_kernel<true><<<blocks, kScoreThreads, 0, stream>>>(
        out, priorities, gumbel, alpha, rows);
  } else {
    per_scores_kernel<false><<<blocks, kScoreThreads, 0, stream>>>(
        out, priorities, gumbel, alpha, rows);
  }
}

void launch_priority_scatter(float* priorities, const int32_t* idx,
                             const float* values,
                             const int32_t* window_start, int64_t k,
                             int64_t rows_local, int sms,
                             cudaStream_t stream) {
  if (rows_local == 0) return;
  int64_t rows = (rows_local + sms - 1) / sms;
  rows = (rows + 31) / 32 * 32;
  if (rows > kScatterRows) rows = kScatterRows;
  const int64_t blocks = (rows_local + rows - 1) / rows;
  priority_scatter_kernel<<<static_cast<unsigned>(blocks), kScatterThreads,
                            rows * sizeof(int32_t), stream>>>(
      priorities, idx, values, window_start, k, rows_local,
      static_cast<int>(rows));
}
