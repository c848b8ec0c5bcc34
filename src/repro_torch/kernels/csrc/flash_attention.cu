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
#include <cstdint>

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
    flash_kernel(float* __restrict__ out, const float* __restrict__ q,
                 const float* __restrict__ k, const float* __restrict__ v,
                 int Sq, int Sk, int H, int KV, int d, float scale,
                 bool causal, int prefix, bool has_window, int window) {
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
    flash_tc_kernel(__nv_bfloat16* __restrict__ out,
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

  // the rows' sums over the quad, the 1e-30 floor, the store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
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
cudaError_t launch_tc(void* out, const void* q, const void* k,
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
      static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(d), scale, causal, prefix, has_window,
      clamp_window(window, Sq, Sk));
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch_tc(void* out, const void* q, const void* k,
                        const void* v, int64_t B, int64_t Sq, int64_t Sk,
                        int64_t H, int64_t KV, int64_t d, float scale,
                        bool causal, int prefix, bool has_window,
                        int64_t window, cudaStream_t stream) {
#define REPRO_FLASH_TC(KD)                                                 \
  return launch_tc<KD, kVec>(out, q, k, v, B, Sq, Sk, H, KV, d, scale,     \
                             causal, prefix, has_window, window, stream)
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
cudaError_t launch_simt(void* out, const void* q, const void* k,
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
      static_cast<float*>(out), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d), scale, causal, prefix,
      has_window, clamp_window(window, Sq, Sk));
  return cudaGetLastError();
}

cudaError_t dispatch_simt(void* out, const void* q, const void* k,
                          const void* v, int64_t B, int64_t Sq, int64_t Sk,
                          int64_t H, int64_t KV, int64_t d, float scale,
                          bool causal, int prefix, bool has_window,
                          int64_t window, cudaStream_t stream) {
#define REPRO_FLASH_SIMT(ND)                                               \
  return launch_simt<ND>(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal, \
                         prefix, has_window, window, stream)
  if (d <= 16) REPRO_FLASH_SIMT(1);
  if (d <= 32) REPRO_FLASH_SIMT(2);
  if (d <= 64) REPRO_FLASH_SIMT(4);
  if (d <= 128) REPRO_FLASH_SIMT(8);
  REPRO_FLASH_SIMT(16);   // d 256: 209 KB of shared memory a block
#undef REPRO_FLASH_SIMT
}

}  // namespace

cudaError_t launch_flash_attention(void* out, const void* q, const void* k,
                                   const void* v, int64_t B, int64_t Sq,
                                   int64_t Sk, int64_t H, int64_t KV,
                                   int64_t d, float scale, bool causal,
                                   int64_t prefix_len, bool has_window,
                                   int64_t window, bool bf16,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  const int prefix = static_cast<int>(prefix_len);   // in [0, Sk]
  if (!bf16)
    return dispatch_simt(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal,
                         prefix, has_window, window, stream);
  const bool vec = d % 8 == 0 && aligned16(out) && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  return vec ? dispatch_tc<true>(out, q, k, v, B, Sq, Sk, H, KV, d, scale,
                                 causal, prefix, has_window, window, stream)
             : dispatch_tc<false>(out, q, k, v, B, Sq, Sk, H, KV, d, scale,
                                  causal, prefix, has_window, window,
                                  stream);
}
