// Flash (online-softmax) GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel). There a (batch, head, q block) cell walks the k blocks
// in grid order and carries its softmax state in VMEM scratch. Here one
// block owns one (b, h, 64-query tile) and loops over the 64-key tiles
// itself; blocks run independently. The query heads of a group
// (h / (H / KV)) read the same KV head; repeated KV is never materialised.
// The mask is the reference's (make_mask, attention.py:83-100): under the
// causal mask a key is visible to a query at or after it, or when it lies
// in the prefix (position < prefix_len: the VLM's patches, seen by every
// query); a window hides keys window or more before the query. So the keys
// a row sees are one range, [max(0, pos - window + 1), min(Sk, max(pos +
// 1, prefix_len))). Masked scores are the finite -1e30 and p = 0 where a
// key is masked, so a row whose keys are all masked (in a tile, or at all)
// gives no NaN; the normaliser has a 1e-30 floor. Key tiles that no row
// of the block can see (after the causal diagonal, before the window) are
// skipped; a fully masked tile leaves the running state as it is.
//
// What bounds it: operations. At the prefill shape (B 8, 1024 tokens, 14
// heads of 64, causal) the two products are 15.05 GFLOP, 0.0152 ms at the
// H100's 989 TFLOP/s bf16 tensor rate (0.23 ms at its float32 rate
// outside the tensor cores); the bytes are ~30 MB, 9 us. P V in two bf16
// parts (below) makes the tensor work 1.5 times that, so this kernel's
// own floor is ~0.023 ms. In practice it is bound by instruction issue
// (the main loop is ~900 SASS instructions a tile at d 64, 96 of them
// mma), so the design keeps the work outside the products small.
//
// bf16 operands (the serving path): flash_tc_kernel, on the tensor cores.
//   * Four warps a block, 16 query rows each; each warp keeps its rows'
//     running max and sum in registers (a row lives on the four lanes of
//     a quad, which reduce with two shuffles). Four blocks an SM at d 64;
//     one at d 256 (paligemma-3b), whose 169 KB of shared memory and 16 x
//     256 float32 accumulator a warp (128 registers a thread) leave room
//     for no second block.
//   * Loads: the Q tile once, then K and V tiles through a ring of two
//     stages in shared memory by 16-byte cp.async with zero fill, so tile
//     t + 1 loads while tile t computes; one barrier a tile. The head dim
//     is padded with zeros to a multiple of 16 (16 kD), and every row by
//     16 bytes, so the eight rows an ldmatrix reads fall in eight distinct
//     bank groups. Rows that 16-byte copies cannot take (d % 8 != 0, or a
//     base off 16 bytes) are loaded element by element by the same kernel
//     (kVec = false).
//   * S = Q K^T: mma.sync m16n8k16, bf16 in, f32 accumulate, fragments by
//     ldmatrix. A bf16 x bf16 product is exact in f32, so only the order
//     of the sums differs from the reference.
//   * Softmax: the masks are one range of keys a row, [vis_lo, vis_hi),
//     so a masked tile costs two compares an element, and a tile that
//     every row of the warp sees whole (most tiles) none. The scale d**-0.5
//     multiplies the f32 scores after the product, as in the reference (:47;
//     folded into bf16 Q it would round Q wherever it is not a power of
//     two: d 80, 96): the row max is taken on the unscaled scores (the
//     scale is positive), and p = 2^(s c - m c) with c = scale log2(e),
//     one FFMA and one ex2 an element.
//   * O += P V: the reference multiplies f32 probabilities by V and never
//     rounds p to bf16. A tensor-core product takes bf16, and one bf16 p
//     (8 bits) puts about a tenth of the outputs more than one bf16 step
//     from the reference (tests/test_torch_model_kernels.py keeps that
//     emulation). So p = hi + lo, hi = bf16(p), lo = bf16(p - hi) (p - hi
//     is exact in f32), keeps ~16 bits, and P V is two products, P_hi V +
//     P_lo V, into one f32 accumulator: half again the tensor work of
//     P V. Both parts are packed in registers straight from the S
//     accumulator, whose fragment is the A fragment of the next mma; P
//     never goes through shared memory. V comes by ldmatrix.trans from
//     its (keys, d) layout. The row sum adds the f32 p, not the parts.
//   * The heaviest causal query tiles are launched first (blockIdx.x
//     reversed), so the tail of the grid is short.
// float32 operands (the card-against-CPU checks, not the serving path)
// keep the SIMT flash_kernel below: the tensor cores cannot hold the
// float32 tolerance (1e-5) without a three-way split of q and k. There 256
// threads share a block, Q, K and V tiles are staged in shared memory,
// and thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty +
// 16 i and keys tx + 16 j (i, j < 4) of the 64 x 64 score tile and output
// columns tx + 16 c; the probabilities go through shared memory to the P
// V product. Each dtype has exactly one kernel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "model_dtype.cuh"
#include "model_ops.h"
#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------------
// float32: SIMT
// ------------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;  // SIMT kernel

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * dp + static_cast<size_t>(kBK) * dp +
          static_cast<size_t>(kBK) * d + static_cast<size_t>(kBQ) * (kBK + 1));
}

// kND = output columns per thread: d <= 16 * kND.
template <int kND>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(float* __restrict__ out, float* __restrict__ lse,
                 const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int Sq, int Sk, int H, int KV,
                 int d, float scale, bool causal, int prefix,
                 bool has_window, int window) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded rows: no bank conflicts
  float* Qs = smem;                     // kBQ x dp
  float* Ks = Qs + kBQ * dp;            // kBK x dp
  float* Vs = Ks + kBK * dp;            // kBK x d
  float* Ps = Vs + kBK * d;             // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    const int i = e - r * d;
    const int s = q0 + r;
    Qs[r * dp + i] =
        s < Sq ? q[((static_cast<int64_t>(b) * Sq + s) * H + h) * d + i]
               : 0.0f;
  }

  float m[4], l[4], acc[4][kND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kND; ++c) acc[i][c] = 0.0f;
  }

  // the keys some row of this block may see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, max(q_offset + q_last + 1, prefix));
  int k_lo = 0;
  if (has_window) k_lo = max(0, q_offset + q0 - window + 1);
  const int kt_end = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  for (int kt = k_lo / kBK; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d;
      const int i = e - r * d;
      const int s = k0 + r;
      const int64_t src = ((static_cast<int64_t>(b) * Sk + s) * KV + kvh) * d
                          + i;
      Ks[r * dp + i] = s < Sk ? k[src] : 0.0f;
      Vs[r * d + i] = s < Sk ? v[src] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * dp + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * dp + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk;
        if (causal) ok[j] = ok[j] && (qpos >= kpos || kpos < prefix);
        if (has_window) ok[j] = ok[j] && (qpos - kpos) < window;
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        sum += p;
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kND; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int key = 0; key < kBK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + key];
#pragma unroll
      for (int c = 0; c < kND; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = Vs[key * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    if (lse != nullptr && tx == 0)   // m is of the scaled scores here
      lse[(static_cast<int64_t>(b) * H + h) * Sq + s] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<int64_t>(b) * Sq + s) * H + h) * d;
#pragma unroll
    for (int c = 0; c < kND; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = acc[i][c] / denom;
    }
  }
}


// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;   // 16 query rows a warp
constexpr int kStages = 2;                  // K/V ring in shared memory

// Shared-memory row length in bf16 values for a head dim padded to 16 kD:
// 16 bytes more than the row, so that rows step through the 16-byte bank
// groups by an odd count and ldmatrix meets no bank conflict.
template <int kD>
__host__ __device__ constexpr int tc_row() {
  return 16 * kD + 8;
}

// Blocks an SM the registers are capped for: four at d <= 64 (the served
// models' 64; 46 KB of shared memory a block, at most 128 registers a
// thread, a few spilled), fewer for wider heads, whose shared-memory ring
// and accumulators are larger: one at d 256, whose shared memory alone
// (169 KB) rules out a second.
template <int kD>
constexpr int kTcMinBlocks = kD <= 4 ? 4 : kD <= 6 ? 3 : kD <= 8 ? 2 : 1;

template <int kD>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(tc_row<kD>()) *
         (kBQ + 2 * kStages * kBK);
}

// Rows [row0, row0 + 64) of a (rows, stride) bf16 matrix, columns [0, d),
// into a 64 x 16 kD tile of shared memory; zeros past `rows` and past d.
// kVec: by 16-byte cp.async (d % 8 == 0 and a 16-byte aligned base);
// otherwise element by element.
template <int kD, bool kVec>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int rows,
                                          int64_t stride, int d, int tid) {
  constexpr int kRow = tc_row<kD>();
  constexpr int kChunks = 2 * kD;             // 16-byte chunks a row
  const int left = rows - row0;
  if constexpr (kVec) {
    // each thread keeps one 16-byte column and steps down the rows: one
    // address computation a call. The threads cover kRowStep rows a step;
    // where 2 kD does not divide their count (kD 5, 6) the last few idle
    // and the last step is partial.
    constexpr int kRowStep = kTcThreads / kChunks;
    constexpr bool kWhole = kRowStep * kChunks == kTcThreads;
    static_assert(!kWhole || kBK % kRowStep == 0, "whole steps");
    const int r0 = tid / kChunks;
    const int col = (tid % kChunks) * 8;
    const __nv_bfloat16* from = src + (row0 + r0) * stride + col;
#pragma unroll
    for (int it = 0; it < (kBK + kRowStep - 1) / kRowStep; ++it) {
      const int r = r0 + it * kRowStep;
      if (kWhole || (r0 < kRowStep && r < kBK)) {
        const bool ok = r < left && col < d;
        cp_async_16(dst + r * kRow + col,
                    ok ? from + it * kRowStep * stride : src, ok);
      }
    }
  } else {
    constexpr int kCols = 16 * kD;
    for (int e = tid; e < kBK * kCols; e += kTcThreads) {
      const int r = e / kCols;
      const int col = e - r * kCols;
      dst[r * kRow + col] = r < left && col < d
                                ? src[(row0 + r) * stride + col]
                                : __ushort_as_bfloat16(0);
    }
  }
}

// One block: 64 query rows of one (b, h), four warps of 16 rows. kD = the
// head dim padded to 16 kD.
template <int kD, bool kVec>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks<kD>)
    flash_tc_kernel(__nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, int Sq, int Sk,
                    int H, int KV, int d, float scale, bool causal,
                    int prefix, bool has_window, int window) {
  constexpr int kRow = tc_row<kD>();
  constexpr int kTile = kBK * kRow;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Ks = Qs + kTile;               // kStages tiles
  __nv_bfloat16* Vs = Ks + kStages * kTile;     // kStages tiles

  // the last query tile (the most keys under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const float scale_log2 = scale * 1.44269504088896341f;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;       // the fragment row (and row + 8)
  const int t = lane % 4;       // the fragment column pair

  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * Sq * H + h) * d;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * Sk * KV + kvh) * d;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * Sk * KV + kvh) * d;
  const int64_t q_stride = static_cast<int64_t>(H) * d;
  const int64_t kv_stride = static_cast<int64_t>(KV) * d;

  // the keys some row of this block may see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, max(q_offset + q_last + 1, prefix));
  int k_lo = 0;
  if (has_window) k_lo = max(0, q_offset + q0 - window + 1);
  const int kt0 = k_lo / kBK;
  const int kt_end = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;
  const int n_tiles = kt_end - kt0;

  float o[2 * kD][4];           // 16 rows x 16 kD columns of the output
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8, unscaled
  float l[2] = {0.0f, 0.0f};         // this thread's share of the row sums

  // tile i of this block's range into its stage of the ring, as one
  // cp.async group (empty past the range, so that the count of groups in
  // flight stays the same)
  auto load_kv = [&](int i) {
    if (i < n_tiles) {
      const int st = i % kStages;
      load_tile<kD, kVec>(Ks + st * kTile, kb, (kt0 + i) * kBK, Sk,
                          kv_stride, d, tid);
      load_tile<kD, kVec>(Vs + st * kTile, vb, (kt0 + i) * kBK, Sk,
                          kv_stride, d, tid);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_tile<kD, kVec>(Qs, qb, q0, Sq, q_stride, d, tid);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load_kv(i);
  }

  // this warp's first query position
  const int qw = q_offset + q0 + 16 * warp;
  // the keys that rows g and g + 8 see (the causal, prefix, window and
  // tail masks as one range): [vis_lo, vis_hi)
  int vis_lo[2], vis_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qpos = qw + g + 8 * r;
    const int64_t first = qpos - window + 1;    // window <= Sq + Sk + 1
    const int64_t last = qpos + 1 > prefix ? qpos + 1 : prefix;
    vis_hi[r] = causal && last < Sk ? static_cast<int>(last) : Sk;
    vis_lo[r] = !has_window || first < 0 ? 0
                : first < Sk             ? static_cast<int>(first)
                                         : Sk;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int kt = kt0 + i;
    const int st = i % kStages;
    cp_async_wait<kStages - 2>();  // tile i (and Q) are in
    // every warp is done with tile i - 1, whose stage now takes tile i +
    // kStages - 1, which loads while this tile computes
    __syncthreads();
    load_kv(i + kStages - 1);
    const __nv_bfloat16* Kt = Ks + st * kTile;
    const __nv_bfloat16* Vt = Vs + st * kTile;

    // S = Q K^T: 16 rows x 64 keys, eight 8-key fragments
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD; ++kk) {
      uint32_t qf[4];
      ldmatrix_x4(qf, Qs + (16 * warp + (lane & 7) +
                            ((lane >> 3) & 1) * 8) * kRow +
                          16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (16 * np + (lane & 7) + (lane >> 4) * 8) *
                                 kRow +
                             16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      }
    }

    // mask, the rows' new max (of the unscaled scores). Element e of
    // fragment n is row g + 8 (e / 2), key k0 + 8 n + 2 t + e % 2. A tile
    // whose every key the warp's 16 rows all see (most tiles) takes no
    // mask; elsewhere each element is two compares with its row's range.
    const int k0 = kt * kBK;
    const bool full = k0 + kBK <= Sk &&
                      (!causal || qw >= k0 + kBK - 1 || k0 + kBK <= prefix) &&
                      (!has_window || qw + 15 - k0 < window);
    int lo_rel[2], hi_rel[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo_rel[r] = vis_lo[r] - (k0 + 2 * t);
      hi_rel[r] = vis_hi[r] - (k0 + 2 * t);
    }
    auto visible = [&](int n, int e) {
      const int c = 8 * n + e % 2;
      return (c >= lo_rel[e / 2]) & (c < hi_rel[e / 2]);
    };
    if (!full) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(n, e)) s[n][e] = kNegInf;
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {      // a tree, not a chain of 16
      float a[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) a[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) a[n] = fmaxf(a[n], a[n + w]);
      mx[r] = a[0];
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];

    // p = exp(s scale - m scale) in f32 (p = 0 where masked), then O +=
    // P_hi V + P_lo V, 16 keys a step: fragments 2 j and 2 j + 1 of S are
    // the A fragment of keys [16 j, 16 j + 16)
    const float m_log2[2] = {m[0] * scale_log2, m[1] * scale_log2};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[half][e] = ex2(fmaf(s[2 * j + half][e], scale_log2,
                                -m_log2[e / 2]));
      if (!full) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(2 * j + half, e)) p[half][e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] += (p[0][2 * r] + p[0][2 * r + 1]) +
                (p[1][2 * r] + p[1][2 * r + 1]);
      uint32_t hi[4], lo[4];
      split_bf16(p[0][0], p[0][1], hi[0], lo[0]);
      split_bf16(p[0][2], p[0][3], hi[1], lo[1]);
      split_bf16(p[1][0], p[1][1], hi[2], lo[2]);
      split_bf16(p[1][2], p[1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < kD; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (16 * j + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kRow +
                                  16 * dp + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], hi, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], hi, vf[2], vf[3]);
        mma_bf16(o[2 * dp], lo, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], lo, vf[2], vf[3]);
      }
    }
  }

  // the rows' sums over the quad, the log-sum-exp (asked for by the
  // backward; m is of the unscaled scores here), the 1e-30 floor, the
  // store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int s_row = q0 + 16 * warp + g + 8 * r;
    if (lse != nullptr && t == 0 && s_row < Sq)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + s_row] =
          l[r] > 0.0f ? m[r] * scale + logf(l[r]) : -INFINITY;
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = q0 + 16 * warp + g + 8 * r;
    if (s_row >= Sq) continue;
    __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * Sq + s_row) *
                                    q_stride + static_cast<int64_t>(h) * d;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n) {
      const int col = 8 * n + 2 * t;
      const float x = o[n][2 * r] / l[r];
      const float y = o[n][2 * r + 1] / l[r];
      if constexpr (kVec) {     // d % 8 == 0: both columns or neither
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// query-key distances lie in [-(Sq + Sk), Sk]: clamping the window to
// that range changes no mask and keeps it an int
int clamp_window(int64_t window, int64_t Sq, int64_t Sk) {
  return static_cast<int>(
      std::clamp<int64_t>(window, -(Sq + Sk), Sq + Sk + 1));
}

template <int kD, bool kVec>
cudaError_t launch_tc(void* out, float* lse, const void* q, const void* k,
                      const void* v, int64_t B, int64_t Sq, int64_t Sk,
                      int64_t H, int64_t KV, int64_t d, float scale,
                      bool causal, int prefix, bool has_window,
                      int64_t window, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<kD>();
  auto kernel = flash_tc_kernel<kD, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<__nv_bfloat16*>(out), lse,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window,
      clamp_window(window, Sq, Sk));
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch_tc(void* out, float* lse, const void* q, const void* k,
                        const void* v, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t H, int64_t KV, int64_t d, float scale,
                        bool causal, int prefix, bool has_window,
                        int64_t window, cudaStream_t stream) {
#define REPRO_FLASH_TC(KD)                                                 \
  return launch_tc<KD, kVec>(out, lse, q, k, v, B, Sq, Sk, H, KV, d,     \
                             scale, causal, prefix, has_window, window,  \
                             stream)
  if (d <= 32) REPRO_FLASH_TC(2);
  if (d <= 64) REPRO_FLASH_TC(4);
  if (d <= 80) REPRO_FLASH_TC(5);
  if (d <= 96) REPRO_FLASH_TC(6);
  if (d <= 128) REPRO_FLASH_TC(8);
  REPRO_FLASH_TC(16);
#undef REPRO_FLASH_TC
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ------------------------------------------------------------------------
// float32: the SIMT kernel's launcher
// ------------------------------------------------------------------------

template <int kND>
cudaError_t launch_simt(void* out, float* lse, const void* q, const void* k,
                        const void* v, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t H, int64_t KV, int64_t d, float scale,
                        bool causal, int prefix, bool has_window,
                        int64_t window, cudaStream_t stream) {
  const size_t smem = smem_bytes(static_cast<int>(d));
  auto kernel = flash_kernel<kND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<float*>(out), lse, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d), scale, causal, prefix,
      has_window, clamp_window(window, Sq, Sk));
  return cudaGetLastError();
}

cudaError_t dispatch_simt(void* out, float* lse, const void* q, const void* k,
                          const void* v, int64_t B, int64_t Sq, int64_t Sk,
                          int64_t H, int64_t KV, int64_t d, float scale,
                          bool causal, int prefix, bool has_window,
                          int64_t window, cudaStream_t stream) {
#define REPRO_FLASH_SIMT(ND)                                               \
  return launch_simt<ND>(out, lse, q, k, v, B, Sq, Sk, H, KV, d, scale,   \
                         causal, prefix, has_window, window, stream)
  if (d <= 16) REPRO_FLASH_SIMT(1);
  if (d <= 32) REPRO_FLASH_SIMT(2);
  if (d <= 64) REPRO_FLASH_SIMT(4);
  if (d <= 128) REPRO_FLASH_SIMT(8);
  REPRO_FLASH_SIMT(16);   // d 256: 209 KB of shared memory a block
#undef REPRO_FLASH_SIMT
}


// ------------------------------------------------------------------------
// backward: float32 math on the CUDA cores (float32; bf16 where the
// tensor-core kernels below do not take it)
// ------------------------------------------------------------------------
//
// Replaces no TPU kernel: the JAX package trains through its jnp path,
// which XLA differentiates (its Pallas kernels have no VJP). The design
// is FlashAttention-2's: P is recomputed from the forward's log-sum-exp
// (p = exp(s scale - lse), 0 where masked), never stored, and
//   delta = rowsum(dout * out),  dS = P * (dout V^T - delta),
//   dV = P^T dout,  dK = scale dS^T Q,  dQ = scale dS K.
// Three launches, each block owning the rows it writes, so no atomics
// and the same bits every run: flash_bwd_delta_kernel (a warp a row);
// flash_bwd_kv_kernel, one block a (b, KV head, key tile), looping over
// the G query heads of the group and the query tiles that can see the
// tile, dK and dV in registers; flash_bwd_q_kernel, one block a (b, h,
// query tile), looping over the key tiles it can see, dQ in registers.
// The layout of work is the forward SIMT kernel's: 256 threads, a tile of
// kB = 16 kR rows by kB columns, thread (ty, tx) = (tid / 16, tid % 16)
// owning rows ty + 16 i and columns tx + 16 j (i, j < kR), and output
// columns tx + 16 c (c < kND: d <= 16 kND); tiles of 64 up to d 128, of 32
// above (shared memory). Operands are converted to float32 as they are
// staged in shared memory, so bf16 runs the same float32 arithmetic.
//
// What bounds it: operations. Against the forward's two products it does
// seven (S and dout V^T in each of the two tile kernels, dV, dK, dQ): ~3.5
// times the forward's FLOPs, here on the CUDA cores (67 TFLOP/s float32).
// bf16 operands with d <= 128 take the tensor-core kernels below
// (mma.sync); wgmma and TMA are later work.

constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_delta_kernel(float* __restrict__ delta,
                           const T* __restrict__ out,
                           const T* __restrict__ dout, int64_t rows, int Sq,
                           int H, int d) {
  const int lane = threadIdx.x % 32;
  // rows in (b, s, h) order, as out is laid out
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float acc = 0.0f;
  for (int i = lane; i < d; i += 32) acc += to_f32(o[i]) * to_f32(g[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = row % H;
    const int64_t bs = row / H;
    delta[((bs / Sq) * H + h) * Sq + bs % Sq] = acc;
  }
}

template <int kR>
__host__ __device__ constexpr int bwd_tile() {
  return 16 * kR;
}

// Shared memory of the two tile kernels, in bytes.
template <int kR>
size_t bwd_kv_smem(int d) {
  constexpr size_t kB = bwd_tile<kR>();
  return sizeof(float) *
         (4 * kB * (d + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int kR>
size_t bwd_q_smem(int d) {
  constexpr size_t kB = bwd_tile<kR>();
  return sizeof(float) * (4 * kB * (d + 1) + kB * (kB + 1));
}

// Whether query position qpos sees key kpos (the forward's masks).
__device__ __forceinline__ bool sees(int qpos, int kpos, int Sk, bool causal,
                                     int prefix, bool has_window,
                                     int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && (qpos >= kpos || kpos < prefix);
  if (has_window) ok = ok && (qpos - kpos) < window;
  return ok;
}

// rows [row0, row0 + kB) of a (b, ., head) slice of a (B, S, heads, d)
// tensor into a kB x (d + 1) float tile; zeros past S
template <typename T, int kB>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int b,
                                           int row0, int S, int heads,
                                           int head, int d, int tid) {
  const int dp = d + 1;
  for (int e = tid; e < kB * d; e += kBwdThreads) {
    const int r = e / d;
    const int i = e - r * d;
    const int s = row0 + r;
    dst[r * dp + i] =
        s < S ? to_f32(src[((static_cast<int64_t>(b) * S + s) * heads +
                            head) * d + i])
              : 0.0f;
  }
}

template <typename T, int kR, int kND>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_kv_kernel(T* __restrict__ dk, T* __restrict__ dv,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int Sq, int Sk,
                        int H, int KV, int d, float scale, bool causal,
                        int prefix, bool has_window, int window) {
  constexpr int kB = bwd_tile<kR>();
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* Ks = smem;                   // kB x dp, this block's keys
  float* Vs = Ks + kB * dp;           // kB x dp
  float* Qs = Vs + kB * dp;           // kB x dp, a query tile
  float* Gs = Qs + kB * dp;           // kB x dp, its dout
  float* Ps = Gs + kB * dp;           // kB x (kB + 1): P, [key][query]
  float* Ss = Ps + kB * (kB + 1);     // kB x (kB + 1): dS, [key][query]
  float* Ls = Ss + kB * (kB + 1);     // kB: the query tile's lse
  float* Ds = Ls + kB;                // kB: its delta

  const int k0 = blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  stage_rows<T, kB>(Ks, k, b, k0, Sk, KV, kvh, d, tid);
  stage_rows<T, kB>(Vs, v, b, k0, Sk, KV, kvh, d, tid);

  float dk_acc[kR][kND], dv_acc[kR][kND];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kND; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // the queries that may see a key of this tile: [s_lo, s_hi). Under the
  // causal mask a tile past the prefix is seen from its first key on; a
  // window hides it from queries window or more past its last key.
  const int k_last = min(k0 + kB, Sk) - 1;
  int64_t s_lo = 0;
  if (causal && k0 >= prefix) s_lo = max(0, k0 - q_offset);
  int64_t s_hi = Sq;
  const int64_t s_win = static_cast<int64_t>(k_last) + window - q_offset;
  if (has_window && s_win < s_hi) s_hi = s_win;
  const int qt0 = static_cast<int>(s_lo / kB);
  const int qt_end = s_hi > s_lo ? static_cast<int>((s_hi + kB - 1) / kB)
                                 : qt0;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = qt0; qt < qt_end; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();   // the previous tile's Qs, Gs, Ps, Ss are consumed
      stage_rows<T, kB>(Qs, q, b, q0, Sq, H, h, d, tid);
      stage_rows<T, kB>(Gs, dout, b, q0, Sq, H, h, d, tid);
      for (int r = tid; r < kB; r += kBwdThreads) {
        const int s = q0 + r;
        Ls[r] = s < Sq ? lse_h[s] : 0.0f;
        Ds[r] = s < Sq ? delta_h[s] : 0.0f;
      }
      __syncthreads();

      // keys ty + 16 i against queries tx + 16 j: S and dout V^T
      float sc[kR][kR], dpv[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) sc[i][j] = dpv[i][j] = 0.0f;
      for (int kk = 0; kk < d; ++kk) {
        float kv_[kR], vv[kR], qv[kR], gv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kv_[i] = Ks[(ty + 16 * i) * dp + kk];
          vv[i] = Vs[(ty + 16 * i) * dp + kk];
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          qv[j] = Qs[(tx + 16 * j) * dp + kk];
          gv[j] = Gs[(tx + 16 * j) * dp + kk];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            sc[i][j] += kv_[i] * qv[j];
            dpv[i][j] += vv[i] * gv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int kr = ty + 16 * i;
          const int qc = tx + 16 * j;
          const bool ok = q0 + qc < Sq &&
                          sees(q_offset + q0 + qc, k0 + kr, Sk, causal,
                               prefix, has_window, window);
          const float p = ok ? expf(sc[i][j] * scale - Ls[qc]) : 0.0f;
          Ps[kr * (kB + 1) + qc] = p;
          Ss[kr * (kB + 1) + qc] = p * (dpv[i][j] - Ds[qc]);
        }
      __syncthreads();

      // dV += P dout, dK += dS Q (over this tile's queries)
      for (int qq = 0; qq < kB; ++qq) {
        float pv[kR], sv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = Ps[(ty + 16 * i) * (kB + 1) + qq];
          sv[i] = Ss[(ty + 16 * i) * (kB + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < kND; ++c) {
          const int col = tx + 16 * c;
          if (col < d) {
            const float gq = Gs[qq * dp + col];
            const float qq_v = Qs[qq * dp + col];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              dv_acc[i][c] += pv[i] * gq;
              dk_acc[i][c] += sv[i] * qq_v;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= Sk) continue;
    const int64_t row = ((static_cast<int64_t>(b) * Sk + s) * KV + kvh) * d;
#pragma unroll
    for (int c = 0; c < kND; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[row + col] = from_f32<T>(dk_acc[i][c] * scale);
        dv[row + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int kR, int kND>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_q_kernel(T* __restrict__ dq, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int Sq, int Sk,
                       int H, int KV, int d, float scale, bool causal,
                       int prefix, bool has_window, int window) {
  constexpr int kB = bwd_tile<kR>();
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* Qs = smem;                   // kB x dp, this block's queries
  float* Gs = Qs + kB * dp;           // kB x dp, their dout
  float* Ks = Gs + kB * dp;           // kB x dp, a key tile
  float* Vs = Ks + kB * dp;           // kB x dp
  float* Ss = Vs + kB * dp;           // kB x (kB + 1): dS, [query][key]

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  stage_rows<T, kB>(Qs, q, b, q0, Sq, H, h, d, tid);
  stage_rows<T, kB>(Gs, dout, b, q0, Sq, H, h, d, tid);
  float lse_r[kR], delta_r[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int s = q0 + ty + 16 * i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + s;
    lse_r[i] = s < Sq ? lse[at] : 0.0f;
    delta_r[i] = s < Sq ? delta[at] : 0.0f;
  }
  float dq_acc[kR][kND];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kND; ++c) dq_acc[i][c] = 0.0f;

  // the keys some row of this block may see: [k_lo, k_hi), as the forward
  const int q_last = min(q0 + kB, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, max(q_offset + q_last + 1, prefix));
  int k_lo = 0;
  if (has_window) k_lo = max(0, q_offset + q0 - window + 1);
  const int kt_end = k_hi > 0 ? (k_hi + kB - 1) / kB : 0;

  for (int kt = k_lo / kB; kt < kt_end; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();   // the previous tile's Ks, Vs, Ss are consumed
    stage_rows<T, kB>(Ks, k, b, k0, Sk, KV, kvh, d, tid);
    stage_rows<T, kB>(Vs, v, b, k0, Sk, KV, kvh, d, tid);
    __syncthreads();

    // queries ty + 16 i against keys tx + 16 j: S and dout V^T
    float sc[kR][kR], dpv[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) sc[i][j] = dpv[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[kR], gv[kR], kv_[kR], vv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qv[i] = Qs[(ty + 16 * i) * dp + kk];
        gv[i] = Gs[(ty + 16 * i) * dp + kk];
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        kv_[j] = Ks[(tx + 16 * j) * dp + kk];
        vv[j] = Vs[(tx + 16 * j) * dp + kk];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          sc[i][j] += qv[i] * kv_[j];
          dpv[i][j] += gv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int qr = ty + 16 * i;
        const int kc = tx + 16 * j;
        const bool ok = q0 + qr < Sq &&
                        sees(q_offset + q0 + qr, k0 + kc, Sk, causal, prefix,
                             has_window, window);
        const float p = ok ? expf(sc[i][j] * scale - lse_r[i]) : 0.0f;
        Ss[qr * (kB + 1) + kc] = p * (dpv[i][j] - delta_r[i]);
      }
    __syncthreads();

    // dQ += dS K (over this tile's keys)
    for (int key = 0; key < kB; ++key) {
      float sv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) sv[i] = Ss[(ty + 16 * i) * (kB + 1) + key];
#pragma unroll
      for (int c = 0; c < kND; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float kval = Ks[key * dp + col];
#pragma unroll
          for (int i = 0; i < kR; ++i) dq_acc[i][c] += sv[i] * kval;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const int64_t row = ((static_cast<int64_t>(b) * Sq + s) * H + h) * d;
#pragma unroll
    for (int c = 0; c < kND; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[row + col] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

template <typename T, int kR, int kND>
cudaError_t launch_bwd_tiles(void* dq, void* dk, void* dv,
                             const float* delta, const void* q,
                             const void* k, const void* v, const void* dout,
                             const float* lse, int64_t B, int64_t Sq,
                             int64_t Sk, int64_t H, int64_t KV, int64_t d,
                             float scale, bool causal, int prefix,
                             bool has_window, int64_t window,
                             cudaStream_t stream) {
  constexpr int kB = bwd_tile<kR>();
  const int win = clamp_window(window, Sq, Sk);
  const size_t kv_smem = bwd_kv_smem<kR>(static_cast<int>(d));
  auto kv_kernel = flash_bwd_kv_kernel<T, kR, kND>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>((Sk + kB - 1) / kB),
                     static_cast<unsigned>(KV), static_cast<unsigned>(B));
  kv_kernel<<<kv_grid, kBwdThreads, kv_smem, stream>>>(
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window, win);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t q_smem = bwd_q_smem<kR>(static_cast<int>(d));
  auto q_kernel = flash_bwd_q_kernel<T, kR, kND>;
  err = cudaFuncSetAttribute(q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  const dim3 q_grid(static_cast<unsigned>((Sq + kB - 1) / kB),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
  q_kernel<<<q_grid, kBwdThreads, q_smem, stream>>>(
      static_cast<T*>(dq), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window, win);
  return cudaGetLastError();
}


// ------------------------------------------------------------------------
// backward, bf16 on the tensor cores (d <= 128)
// ------------------------------------------------------------------------
//
// The same three launches and the same split of the work as the SIMT
// kernels above, with the products on mma.sync m16n8k16 (bf16 in, f32
// accumulate) and the fragments the forward's flash_tc_kernel uses: four
// warps a block, 16 rows a warp, tiles of 64, the head dim padded to 16
// kD in shared memory. The key-tile kernel takes the transposed products,
// so that its accumulators are its warp's 16 keys: S^T = K Q^T and dP^T =
// V dout^T (K and V as A fragments, Q and dout rows as B fragments, as
// the forward's Q and K); P^T and dS^T, rounded to bf16 once, are the A
// fragments of dV += P^T dout and dK += dS^T Q straight from the
// accumulators (dout and Q by ldmatrix.trans, as the forward's V). The
// query-tile kernel takes S = Q K^T and dP = dout V^T and then dQ += dS K
// (K by ldmatrix.trans). Tiles load by 16-byte cp.async (d % 8 == 0 and
// 16-byte aligned bases: otherwise, and for d > 128, whose accumulators
// would not fit the registers, the SIMT kernels run). Each mask is one
// range a row: the keys a query sees, or the queries that see a key.

constexpr float kLog2e = 1.44269504088896341f;
constexpr int kBig = 1 << 30;     // past any position

template <int kD>
__host__ __device__ constexpr size_t bwd_tc_smem() {
  return 4 * static_cast<size_t>(kBK) * tc_row<kD>() *
             sizeof(__nv_bfloat16) +
         2 * kBQ * sizeof(float);
}

// rows [row0, row0 + 64) of head `head` of a (B, S, heads, d) bf16 tensor
// into a tile, as one cp.async group
template <int kD>
__device__ __forceinline__ void load_rows_tc(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src, int b,
                                             int row0, int S, int heads,
                                             int head, int d, int tid) {
  load_tile<kD, true>(dst, src + (static_cast<int64_t>(b) * S * heads +
                                  head) * d,
                      row0, S, static_cast<int64_t>(heads) * d, d, tid);
}

// p = 2^(s scale log2e - lse log2e) where visible (0 elsewhere) and ds =
// p (dp - delta), in place over a 16 x 64 accumulator pair; element e of
// fragment n sits at row r = e / 2 and column col0 + 8 n + 2 t + e % 2,
// which is visible when it lies in [lo[r], hi[r]). lse2 and dlt give each
// element's log2-scaled LSE and delta.
template <typename LseFn, typename DeltaFn>
__device__ __forceinline__ void probs_and_ds(float (&s)[8][4],
                                             float (&dp)[8][4], int col0,
                                             const int (&lo)[2],
                                             const int (&hi)[2],
                                             float scale_log2, LseFn lse2,
                                             DeltaFn dlt) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col0 + 8 * n + e % 2;
      const bool ok = c >= lo[e / 2] && c < hi[e / 2];
      const float p = ok ? ex2(fmaf(s[n][e], scale_log2, -lse2(n, e)))
                         : 0.0f;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - dlt(n, e));
    }
}

// the A fragment of 16 columns (fragments 2 j and 2 j + 1) of a 16 x 64
// accumulator, rounded to bf16
__device__ __forceinline__ void acc_to_a(const float (&x)[8][4], int j,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

// S (or S^T) and dP (or dP^T) of a warp's 16 rows against 64 columns: A
// fragments from rows 16 warp.. of A1s and A2s, B fragments from the 64
// rows of B1s and B2s
template <int kD>
__device__ __forceinline__ void two_products(float (&s)[8][4],
                                             float (&dp)[8][4],
                                             const __nv_bfloat16* A1s,
                                             const __nv_bfloat16* A2s,
                                             const __nv_bfloat16* B1s,
                                             const __nv_bfloat16* B2s,
                                             int warp, int lane) {
  constexpr int kRow = tc_row<kD>();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kD; ++kk) {
    const int a_at = (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                     16 * kk + (lane >> 4) * 8;
    uint32_t a1[4], a2[4];
    ldmatrix_x4(a1, A1s + a_at);
    ldmatrix_x4(a2, A2s + a_at);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int b_at = (16 * np + (lane & 7) + (lane >> 4) * 8) * kRow +
                       16 * kk + ((lane >> 3) & 1) * 8;
      uint32_t b1[4], b2[4];
      ldmatrix_x4(b1, B1s + b_at);
      ldmatrix_x4(b2, B2s + b_at);
      mma_bf16(s[2 * np], a1, b1[0], b1[1]);
      mma_bf16(s[2 * np + 1], a1, b1[2], b1[3]);
      mma_bf16(dp[2 * np], a2, b2[0], b2[1]);
      mma_bf16(dp[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc (16 x 16 kD) += a (16 x 16 chunk j of the columns) times rows [16 j,
// 16 j + 16) of Bs (64 x 16 kD), by ldmatrix.trans
template <int kD>
__device__ __forceinline__ void product_into(float (&acc)[2 * kD][4],
                                             const uint32_t (&a)[4],
                                             const __nv_bfloat16* Bs, int j,
                                             int lane) {
  constexpr int kRow = tc_row<kD>();
#pragma unroll
  for (int dp = 0; dp < kD; ++dp) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, Bs + (16 * j + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * kRow +
                              16 * dp + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
    mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
  }
}

// rows row0 + g, row0 + g + 8 of a 16 x 16 kD accumulator, times `mul`,
// into a (rows, heads, d) bf16 tensor's head slice
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[2 * kD][4],
                                           float mul, int row0, int rows,
                                           int64_t stride, int d, int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < d)    // d % 8 == 0: both columns or neither
        *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul,
                                  acc[n][2 * r + 1] * mul);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_kv_tc_kernel(__nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv,
                           const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int Sq, int Sk,
                           int H, int KV, int d, float scale, bool causal,
                           int prefix, bool has_window, int window) {
  constexpr int kTile = kBK * tc_row<kD>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* Vs = Ks + kTile;
  __nv_bfloat16* Qs = Vs + kTile;
  __nv_bfloat16* Gs = Qs + kTile;
  float* Ls = reinterpret_cast<float*>(Gs + kTile);   // lse log2 e
  float* Ds = Ls + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int q_offset = Sk - Sq;
  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_rows_tc<kD>(Ks, k, b, k0, Sk, KV, kvh, d, tid);
  load_rows_tc<kD>(Vs, v, b, k0, Sk, KV, kvh, d, tid);
  cp_async_commit();

  float dk_acc[2 * kD][4], dv_acc[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  // the query positions that see this warp's keys g and g + 8, minus
  // q_offset (query indices): [lo, hi), empty past Sk
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + 16 * warp + g + 8 * r;
    lo[r] = causal && kpos >= prefix ? kpos - q_offset : -kBig;
    hi[r] = has_window ? kpos + window - q_offset : kBig;
    if (hi[r] > Sq) hi[r] = Sq;
    if (kpos >= Sk) hi[r] = lo[r];
  }

  // the query tiles that may see a key of this tile, as the SIMT kernel
  const int k_last = min(k0 + kBK, Sk) - 1;
  int64_t s_lo = 0;
  if (causal && k0 >= prefix) s_lo = max(0, k0 - q_offset);
  int64_t s_hi = Sq;
  const int64_t s_win = static_cast<int64_t>(k_last) + window - q_offset;
  if (has_window && s_win < s_hi) s_hi = s_win;
  const int qt0 = static_cast<int>(s_lo / kBQ);
  const int qt_end = s_hi > s_lo ? static_cast<int>((s_hi + kBQ - 1) / kBQ)
                                 : qt0;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * Sq;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * Sq;
    for (int qt = qt0; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the previous tile's Qs, Gs, Ls, Ds are consumed
      load_rows_tc<kD>(Qs, q, b, q0, Sq, H, h, d, tid);
      load_rows_tc<kD>(Gs, dout, b, q0, Sq, H, h, d, tid);
      cp_async_commit();
      for (int r = tid; r < kBQ; r += kTcThreads) {
        const int s = q0 + r;
        Ls[r] = s < Sq ? lse_h[s] * kLog2e : 0.0f;
        Ds[r] = s < Sq ? delta_h[s] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float st[8][4], dpt[8][4];    // S^T, dP^T: 16 keys x 64 queries
      two_products<kD>(st, dpt, Ks, Vs, Qs, Gs, warp, lane);
      probs_and_ds(st, dpt, q0 + 2 * t, lo, hi, scale_log2,
                   [&](int n, int e) { return Ls[8 * n + 2 * t + e % 2]; },
                   [&](int n, int e) { return Ds[8 * n + 2 * t + e % 2]; });
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pa[4], sa[4];
        acc_to_a(st, j, pa);
        acc_to_a(dpt, j, sa);
        product_into<kD>(dv_acc, pa, Gs, j, lane);
        product_into<kD>(dk_acc, sa, Qs, j, lane);
      }
    }
  }
  cp_async_wait<0>();   // K and V, where no query tile ran

  const int64_t stride = static_cast<int64_t>(KV) * d;
  const int64_t base = (static_cast<int64_t>(b) * Sk * KV + kvh) * d;
  store_rows<kD>(dk + base, dk_acc, scale, k0 + 16 * warp, Sk, stride, d,
                 g, t);
  store_rows<kD>(dv + base, dv_acc, 1.0f, k0 + 16 * warp, Sk, stride, d,
                 g, t);
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_q_tc_kernel(__nv_bfloat16* __restrict__ dq,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int Sq, int Sk,
                          int H, int KV, int d, float scale, bool causal,
                          int prefix, bool has_window, int window) {
  constexpr int kTile = kBK * tc_row<kD>();
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* Gs = Qs + kTile;
  __nv_bfloat16* Ks = Gs + kTile;
  __nv_bfloat16* Vs = Ks + kTile;

  // the last query tile (the most keys under the causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const float scale_log2 = scale * kLog2e;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_rows_tc<kD>(Qs, q, b, q0, Sq, H, h, d, tid);
  load_rows_tc<kD>(Gs, dout, b, q0, Sq, H, h, d, tid);
  cp_async_commit();

  // rows g and g + 8 of this warp: their log2-scaled LSE, delta and the
  // keys they see, [lo, hi) (the forward's ranges)
  float lse2[2], dlt[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 16 * warp + g + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + s;
    lse2[r] = s < Sq ? lse[at] * kLog2e : 0.0f;
    dlt[r] = s < Sq ? delta[at] : 0.0f;
    const int64_t qpos = q_offset + s;
    const int64_t first = qpos - window + 1;
    const int64_t last = qpos + 1 > prefix ? qpos + 1 : prefix;
    hi[r] = causal && last < Sk ? static_cast<int>(last) : Sk;
    lo[r] = !has_window || first < 0 ? 0
            : first < Sk             ? static_cast<int>(first)
                                     : Sk;
    if (s >= Sq) hi[r] = lo[r];
  }
  float dq_acc[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, max(q_offset + q_last + 1, prefix));
  int k_lo = 0;
  if (has_window) k_lo = max(0, q_offset + q0 - window + 1);
  const int kt_end = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  for (int kt = k_lo / kBK; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's Ks and Vs are consumed
    load_rows_tc<kD>(Ks, k, b, k0, Sk, KV, kvh, d, tid);
    load_rows_tc<kD>(Vs, v, b, k0, Sk, KV, kvh, d, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];        // S, dP: 16 queries x 64 keys
    two_products<kD>(s, dp, Qs, Gs, Ks, Vs, warp, lane);
    probs_and_ds(s, dp, k0 + 2 * t, lo, hi, scale_log2,
                 [&](int, int e) { return lse2[e / 2]; },
                 [&](int, int e) { return dlt[e / 2]; });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t sa[4];
      acc_to_a(dp, j, sa);
      product_into<kD>(dq_acc, sa, Ks, j, lane);
    }
  }

  const int64_t stride = static_cast<int64_t>(H) * d;
  store_rows<kD>(dq + (static_cast<int64_t>(b) * Sq * H + h) * d, dq_acc,
                 scale, q0 + 16 * warp, Sq, stride, d, g, t);
}

template <int kD>
cudaError_t launch_bwd_tc(void* dq, void* dk, void* dv, const float* delta,
                          const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, int64_t B,
                          int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                          int64_t d, float scale, bool causal, int prefix,
                          bool has_window, int64_t window,
                          cudaStream_t stream) {
  constexpr size_t smem = bwd_tc_smem<kD>();
  const int win = clamp_window(window, Sq, Sk);
  using bf = __nv_bfloat16;
  auto kv_kernel = flash_bwd_kv_tc_kernel<kD>;
  auto q_kernel = flash_bwd_q_tc_kernel<kD>;
  for (const void* kern : {reinterpret_cast<const void*>(kv_kernel),
                           reinterpret_cast<const void*>(q_kernel)}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 kv_grid(static_cast<unsigned>((Sk + kBK - 1) / kBK),
                     static_cast<unsigned>(KV), static_cast<unsigned>(B));
  kv_kernel<<<kv_grid, kTcThreads, smem, stream>>>(
      static_cast<bf*>(dk), static_cast<bf*>(dv), static_cast<const bf*>(q),
      static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window, win);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(H), static_cast<unsigned>(B));
  q_kernel<<<q_grid, kTcThreads, smem, stream>>>(
      static_cast<bf*>(dq), static_cast<const bf*>(q),
      static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window, win);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(void* dq, void* dk, void* dv, float* delta,
                       const void* q, const void* k, const void* v,
                       const void* out, const float* lse, const void* dout,
                       int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                       int64_t KV, int64_t d, float scale, bool causal,
                       int prefix, bool has_window, int64_t window,
                       cudaStream_t stream) {
  const int64_t rows = B * Sq * H;
  constexpr int kRowsPerBlock = kBwdThreads / 32;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(
                                  (rows + kRowsPerBlock - 1) / kRowsPerBlock),
                              kBwdThreads, 0, stream>>>(
      delta, static_cast<const T*>(out), static_cast<const T*>(dout), rows,
      static_cast<int>(Sq), static_cast<int>(H), static_cast<int>(d));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const bool vec = d % 8 == 0 && d <= 128 && aligned16(q) &&
                     aligned16(k) && aligned16(v) && aligned16(dout) &&
                     aligned16(dq) && aligned16(dk) && aligned16(dv);
#define REPRO_FLASH_BWD_TC(KD)                                            \
  return launch_bwd_tc<KD>(dq, dk, dv, delta, q, k, v, dout, lse, B, Sq,  \
                           Sk, H, KV, d, scale, causal, prefix,          \
                           has_window, window, stream)
    if (vec) {
      if (d <= 32) REPRO_FLASH_BWD_TC(2);
      if (d <= 64) REPRO_FLASH_BWD_TC(4);
      if (d <= 80) REPRO_FLASH_BWD_TC(5);
      if (d <= 96) REPRO_FLASH_BWD_TC(6);
      REPRO_FLASH_BWD_TC(8);
    }
#undef REPRO_FLASH_BWD_TC
  }
#define REPRO_FLASH_BWD(R, ND)                                             \
  return launch_bwd_tiles<T, R, ND>(dq, dk, dv, delta, q, k, v, dout, lse, \
                                    B, Sq, Sk, H, KV, d, scale, causal,    \
                                    prefix, has_window, window, stream)
  if (d <= 32) REPRO_FLASH_BWD(4, 2);
  if (d <= 64) REPRO_FLASH_BWD(4, 4);
  if (d <= 128) REPRO_FLASH_BWD(4, 8);
  REPRO_FLASH_BWD(2, 16);    // tiles of 32: 140 KB of shared memory
#undef REPRO_FLASH_BWD
}

}  // namespace

cudaError_t launch_flash_attention(void* out, float* lse, const void* q,
                                   const void* k, const void* v, int64_t B,
                                   int64_t Sq, int64_t Sk, int64_t H,
                                   int64_t KV, int64_t d, float scale,
                                   bool causal, int64_t prefix_len,
                                   bool has_window, int64_t window,
                                   bool bf16, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const int prefix = static_cast<int>(prefix_len);   // in [0, Sk]
  if (!bf16)
    return dispatch_simt(out, lse, q, k, v, B, Sq, Sk, H, KV, d, scale,
                         causal, prefix, has_window, window, stream);
  const bool vec = d % 8 == 0 && aligned16(out) && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  return vec ? dispatch_tc<true>(out, lse, q, k, v, B, Sq, Sk, H, KV, d,
                                 scale, causal, prefix, has_window, window,
                                 stream)
             : dispatch_tc<false>(out, lse, q, k, v, B, Sq, Sk, H, KV, d,
                                  scale, causal, prefix, has_window, window,
                                  stream);
}

cudaError_t launch_flash_attention_bwd(
    void* dq, void* dk, void* dv, float* delta, const void* q,
    const void* k, const void* v, const void* out, const float* lse,
    const void* dout, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
    int64_t KV, int64_t d, float scale, bool causal, int64_t prefix_len,
    bool has_window, int64_t window, bool bf16, cudaStream_t stream) {
  // no query or no key: the binding's outputs are zeros
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return cudaSuccess;
  const int prefix = static_cast<int>(prefix_len);   // in [0, Sk]
  return bf16 ? launch_bwd<__nv_bfloat16>(dq, dk, dv, delta, q, k, v, out,
                                          lse, dout, B, Sq, Sk, H, KV, d,
                                          scale, causal, prefix, has_window,
                                          window, stream)
              : launch_bwd<float>(dq, dk, dv, delta, q, k, v, out, lse, dout,
                                  B, Sq, Sk, H, KV, d, scale, causal, prefix,
                                  has_window, window, stream);
}
