// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 math.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel).
// There the grid is (batch, head, chunk) with the chunk axis sequential
// ("arbitrary"): the (P, N) state sits in VMEM scratch and is carried from
// one grid step to the next. Hopper runs blocks in no order, so nothing
// carries over; but of the scan only the state recurrence is sequential,
// and it is elementwise over (P, N). So a call runs three passes, as the
// SSD algorithm itself splits the work, each spread across the card:
//
//   1. Chunk states, one block per (b, h, chunk): A_cum = cumsum(dtA) over
//      the chunk (kept in the f32 scratch `acum`, (B, H, S)) and the
//      chunk's own contribution
//        dS_c = x_c^T (B_c * exp(A_cum[L-1] - A_cum))           (P, N)
//      into the f32 scratch `states`, (B, H, chunks, P, N).
//   2. The state pass, one thread per (b, h, p, n): over the chunks in
//      order, from the float32 initial state (or from zero without one),
//        S_{c+1} = exp(A_cum_c[L-1]) S_c + dS_c,
//      writing over dS_c the state S_c that chunk c starts from (the
//      backward, ssd_scan_bwd.cu, reads them there), and the final state
//      in x's dtype.
//   3. y, one block per (b, h, chunk, 64-row query tile):
//        y[t] = sum_{s <= t} (C[t] . B[s]) exp(A_cum[t] - A_cum[s]) x[s]
//               + exp(A_cum[t]) (C[t] . S_c)
//      over the causal 64-row key tiles; key tiles past the diagonal are
//      skipped (their decay weights are 0), and so is the state term of
//      the first chunk when the scan starts from zero. The heaviest query
//      tiles (the most key tiles) are launched first, so the tail of the
//      grid is short.
// Blocks of 128 threads; tiles come in by 16-byte cp.async where rows
// allow it (rows of a multiple of 16 bytes from 16-byte aligned bases),
// otherwise element by element, with zeros past the edges.
//
// bf16 operands (the serving path): passes 1 and 3 on the tensor cores,
// mma.sync m16n8k16 with bf16 fragments by ldmatrix (tensor_core.cuh),
// float32 accumulators, four warps a block. The reference computes in
// float32 from the bf16 inputs, so only products whose operands are bf16
// values may go to the tensor cores as they are:
//   * C B^T: both bf16, each product exact in float32; only the order of
//     the sums differs from the reference.
//   * (masked scores) x, C S_c^T and x^T (B * decay): the scores, the state
//     and B * decay are float32. Each is split into hi = bf16(v) and lo =
//     bf16(v - hi) (v - hi is exact in float32), about 16 bits of v, and
//     the product is the two products summed in float32 (flash's P V does
//     the same). One bf16 rounding would put ~10% of y beyond the card's
//     tolerance; hi + lo puts none (tests/test_torch_ssd_scan.py emulates
//     both).
//   Pass 1 multiplies B by the decays and splits it on the way into shared
//   memory (a warp takes a quarter of N, so each part feeds one warp);
//   pass 3 splits the state there, and the scores in registers, where the
//   score accumulator is already the A fragment of the next product. A
//   warp keeps its 16 query rows of C as A fragments for the whole block.
//   Key tiles come through a ring of two stages, so tile k + 1 loads while
//   tile k computes; the state's parts use the ring before the first key
//   tile, which leaves 72 KB a block at mamba2's N 128 (three blocks an
//   SM) and 47 KB at zamba2's N 64 (four, with the registers capped to
//   match). On the diagonal key tile a warp skips the 16-key blocks past
//   its last row. The decays are 2^((A_cum[t] - A_cum[s]) log2 e): the
//   difference is exact where the weight is large, and ex2 takes one
//   instruction where expf takes several. Loads that go through registers
//   (B, the state) are issued four at a time before any is split.
// float32 operands (the card-against-CPU checks, not the serving path)
// stay on the SIMT units: the tensor cores would need a three-way split of
// every operand to hold the float32 tolerance. Thread (ty, tx) = (tid /
// 16, tid % 16) keeps a register tile of 8 rows by 4 or 8 columns, fed by
// 16-byte shared loads:
//   * chunk states: rows p = 4 ty + 32 i + r, columns n = 4 tx + 64 j + r,
//     both operands read as float4 along their rows (x[s][p], B[s][n]);
//   * C B^T and C S^T: rows t = 4 ty + 32 i + r, columns s (or p) = tx +
//     16 j; four-wide dot products along N, float4 from rows that lie one
//     16-byte bank group apart (a row pitch of 16 bytes mod 128);
//   * masked scores times x: the scores go through shared memory
//     transposed, read as float4 along t, and x read along p.
//
// What bounds it: bytes. At the serving shapes (B 8, S 1024, bf16, L 256)
// mamba2-130m (H 24, P 64, N 128) moves 154.9 MB (0.046 ms at 3.35 TB/s)
// for 25.8 GFLOP of the reference's L x L products (0.026 ms at the bf16
// tensor rate); zamba2-1.2b (H 64, P 64, N 64) 274.7 MB (0.082 ms) for
// 42.9 GFLOP. B and C arrive broadcast to every head (the reference's
// interface), so the bytes count H copies of them. The scratch adds 25 MB
// (mamba2) or 34 MB (zamba2) of states, written, read and rewritten once.
// The causal tiling skips about a third of the L x L work, and the hi +
// lo splits add half of it back, so the tensor work is ~29 GFLOP (mamba2)
// and ~49 (zamba2): 0.03 and 0.05 ms at the bf16 tensor rate.

#include "model_dtype.cuh"
#include "model_ops.h"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;             // rows of a query, key or state tile
constexpr int kThreads = 128;      // the chunk-state and y kernels
constexpr int kPassThreads = 256;  // the state pass
constexpr float kLog2e = 1.44269504088896341f;

// Rows [0, tile_rows) of a shared tile of T with row pitch ld, columns
// [0, Wpad): row r < rows, column < W from src + r * stride + column,
// zeros elsewhere. vec: W is a multiple of 16 bytes' elements and every
// row starts 16-byte aligned, so rows go by 16-byte cp.async (the caller
// commits and waits); otherwise element by element.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int rows,
                                          int tile_rows, int W, int Wpad,
                                          bool vec) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);  // elements a 16-byte chunk
    const int per_row = Wpad / kE;
    for (int e = threadIdx.x; e < tile_rows * per_row; e += blockDim.x) {
      const int r = e / per_row;
      const int col = (e - r * per_row) * kE;
      const bool ok = r < rows && col < W;
      cp_async_16(dst + r * ld + col, ok ? src + r * stride + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < tile_rows * Wpad; e += blockDim.x) {
      const int r = e / Wpad;
      const int col = e - r * Wpad;
      dst[r * ld + col] = r < rows && col < W ? src[r * stride + col]
                                              : from_f32<T>(0.0f);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Ac[t] = dA[0] + ... + dA[t * H] for t < L (the chunk's A_cum), and a
// copy into out. The first warp scans: a run of rows a lane, then a
// shuffle scan of the lane totals. Ends with the block synchronised.
__device__ void chunk_cumsum(float* Ac, const float* __restrict__ dA,
                             int64_t H, int L, float* __restrict__ out) {
  for (int t = threadIdx.x; t < L; t += blockDim.x) Ac[t] = dA[t * H];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (L + 31) / 32;
    const int lo = lane * per;
    float run = 0.0f;
    for (int k = 0; k < per && lo + k < L; ++k) {
      run += Ac[lo + k];
      Ac[lo + k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const float base = incl - run;
    for (int k = 0; k < per && lo + k < L; ++k) Ac[lo + k] += base;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += blockDim.x) out[t] = Ac[t];
}

// The scan's (b, h, chunk) of a block of the chunk-state and y kernels:
// blockIdx.x = h * chunks + c, blockIdx.y = b.
struct Cell {
  int c, h, b, c0;
  int64_t bh, row_b;  // b * H + h; the flat (b, 0, h) row of x, B_, C_
};

__device__ __forceinline__ Cell cell(int S, int H, int L) {
  const int nc = S / L;
  Cell k;
  k.c = blockIdx.x % nc;
  k.h = blockIdx.x / nc;
  k.b = blockIdx.y;
  k.c0 = k.c * L;
  k.bh = static_cast<int64_t>(k.b) * H + k.h;
  k.row_b = static_cast<int64_t>(k.b) * S * H + k.h;
  return k;
}

// ------------------------------------------------------------------------
// pass 2, both dtypes: blockIdx.x = b * H + h, a thread one element of the
// (P, N) state
// ------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(T* __restrict__ fin, float* __restrict__ states,
                          const float* __restrict__ acum,
                          const float* __restrict__ init, int S, int L,
                          int PN) {
  constexpr int kGroup = 8;  // chunks whose loads are in flight together
  const int64_t bh = blockIdx.x;
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const int nc = S / L;
  float* st = states + bh * nc * PN + e;
  const float* a_last = acum + bh * S + L - 1;
  float s = init != nullptr ? init[bh * PN + e] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kGroup) {
    float d[kGroup], carry[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (c0 + j < nc) {
        d[j] = st[static_cast<int64_t>(c0 + j) * PN];
        carry[j] = expf(a_last[static_cast<int64_t>(c0 + j) * L]);
      }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (c0 + j < nc) {
        st[static_cast<int64_t>(c0 + j) * PN] = s;
        s = carry[j] * s + d[j];
      }
  }
  fin[bh * PN + e] = from_f32<T>(s);
}

// ------------------------------------------------------------------------
// float32: SIMT
// ------------------------------------------------------------------------

// Shared row pitch, in floats, of a tile of 64 g columns: 4 floats more,
// so that consecutive rows start one 16-byte bank group apart.
__host__ __device__ constexpr int simt_ld(int g) { return 64 * g + 4; }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float at(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Pass 1. kPG, kNG: P and N padded to 64 kPG and 64 kNG.
template <int kPG, int kNG>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(float* __restrict__ states,
                           float* __restrict__ acum,
                           const float* __restrict__ x,
                           const float* __restrict__ dtA,
                           const float* __restrict__ Bm, int S, int H, int P,
                           int N, int L, bool vec) {
  constexpr int kLdP = simt_ld(kPG);
  constexpr int kLdN = simt_ld(kNG);
  extern __shared__ __align__(16) float smem[];
  float* Ac = smem;                  // kMaxSsdChunk: A_cum of the chunk
  float* Dc = Ac + kMaxSsdChunk;     // kT: the decays of a tile's rows
  float* Xs = Dc + kT;               // kT x kLdP
  float* Bs = Xs + kT * kLdP;        // kT x kLdN

  const Cell k = cell(S, H, L);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  chunk_cumsum(Ac, dtA + k.row_b + static_cast<int64_t>(k.c0) * H, H, L,
               acum + k.bh * S + k.c0);
  const float a_last = Ac[L - 1];

  float acc[8 * kPG][4 * kNG];
#pragma unroll
  for (int i = 0; i < 8 * kPG; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kNG; ++j) acc[i][j] = 0.0f;

  for (int s0 = 0; s0 < L; s0 += kT) {
    const int nk = min(kT, L - s0);
    __syncthreads();  // the previous tile is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_rows(Xs, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
              64 * kPG, vec);
    load_rows(Bs, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, kT, N,
              64 * kNG, vec);
    cp_async_commit();
    if (tid < kT) Dc[tid] = tid < nk ? expf(a_last - Ac[s0 + tid]) : 0.0f;
    cp_async_wait<0>();
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float d = Dc[s];
      float4 xv[2 * kPG], bv[kNG];
#pragma unroll
      for (int i = 0; i < 2 * kPG; ++i)
        xv[i] = ld4(Xs + s * kLdP + 4 * ty + 32 * i);
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        bv[j] = ld4(Bs + s * kLdN + 4 * tx + 64 * j);
        bv[j] = make_float4(bv[j].x * d, bv[j].y * d, bv[j].z * d,
                            bv[j].w * d);
      }
#pragma unroll
      for (int i = 0; i < 8 * kPG; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kNG; ++j)
          acc[i][j] = fmaf(at(xv[i / 4], i % 4), at(bv[j / 4], j % 4),
                           acc[i][j]);
    }
  }

  float* out = states + (k.bh * (S / L) + k.c) * P * N;
#pragma unroll
  for (int i = 0; i < 8 * kPG; ++i) {
    const int p = 4 * ty + 32 * (i / 4) + i % 4;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      const int n = 4 * tx + 64 * j;
      float* row = out + static_cast<int64_t>(p) * N + n;
      if (N % 4 == 0) {
        if (n < N)
          *reinterpret_cast<float4*>(row) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                          acc[i][4 * j + 2], acc[i][4 * j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) row[q] = acc[i][4 * j + q];
      }
    }
  }
}

// Pass 3: query tile gridDim.z - 1 - blockIdx.z of the cell's chunk.
template <int kPG, int kNG>
__global__ void __launch_bounds__(kThreads)
    ssd_y_kernel(float* __restrict__ y, const float* __restrict__ x,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ acum,
                 const float* __restrict__ states, int S, int H, int P, int N,
                 int L, bool vec, bool has_init) {
  constexpr int kLdP = simt_ld(kPG);
  constexpr int kLdN = simt_ld(kNG);
  constexpr int kLdS = kT + 4;
  constexpr int kPC = 4 * kPG;       // columns p = tx + 16 j, j < kPC
  extern __shared__ __align__(16) float smem[];
  float* Ac = smem;                      // kMaxSsdChunk
  float* Cs = Ac + kMaxSsdChunk;         // kT x kLdN: C rows of the tile
  float* BSs = Cs + kT * kLdN;           // the state (64 kPG x kLdN), then
                                         // a key tile's B rows (kT x kLdN)
  float* Xs = BSs + 64 * kPG * kLdN;     // kT x kLdP: a key tile's x rows
  float* Ps = Xs + kT * kLdP;            // kT x kLdS: masked scores [s][t]

  const Cell k = cell(S, H, L);
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int t0 = qt * kT;
  const int nq = min(kT, L - t0);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int nc = S / L;

  for (int t = tid; t < t0 + nq; t += kThreads)
    Ac[t] = acum[k.bh * S + k.c0 + t];
  load_rows(Cs, kLdN,
            Cm + (k.row_b + static_cast<int64_t>(k.c0 + t0) * H) * N,
            static_cast<int64_t>(H) * N, nq, kT, N, 64 * kNG, vec);
  const bool has_state = k.c > 0 || has_init;
  if (has_state)
    load_rows(BSs, kLdN, states + (k.bh * nc + k.c) * P * N,
              static_cast<int64_t>(N), P, 64 * kPG, N, 64 * kNG, N % 4 == 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // rows t = 4 ty + 32 (i / 4) + i % 4 of the tile, i < 8
  float acc[8][kPC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kPC; ++j) acc[i][j] = 0.0f;
  if (has_state) {  // exp(A_cum[t]) C[t] . S_c
    for (int n = 0; n < 64 * kNG; n += 4) {
      float4 cv[8], sv[kPC];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = ld4(Cs + (4 * ty + 32 * (i / 4) + i % 4) * kLdN + n);
#pragma unroll
      for (int j = 0; j < kPC; ++j)
        sv[j] = ld4(BSs + (tx + 16 * j) * kLdN + n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kPC; ++j)
          acc[i][j] = dot4(cv[i], sv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 4 * ty + 32 * (i / 4) + i % 4;
      const float decay = t < nq ? expf(Ac[t0 + t]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kPC; ++j) acc[i][j] *= decay;
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int s0 = kt * kT;
    const int nk = min(kT, L - s0);
    __syncthreads();  // the state, or the previous key tile, is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_rows(BSs, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, kT,
              N, 64 * kNG, vec);
    load_rows(Xs, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
              64 * kPG, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // scores C[t] . B[s] for keys s = tx + 16 j, j < 4
    float g[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
    for (int n = 0; n < 64 * kNG; n += 4) {
      float4 cv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = ld4(Cs + (4 * ty + 32 * (i / 4) + i % 4) * kLdN + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(BSs + (tx + 16 * j) * kLdN + n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = dot4(cv[i], bv[j], g[i][j]);
    }
    // masked and decayed, into Ps transposed: Ps[s][t]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tx + 16 * j;
#pragma unroll
      for (int i4 = 0; i4 < 2; ++i4) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 4 * ty + 32 * i4 + r;
          v[r] = s0 + s <= t0 + t && t < nq
                     ? g[4 * i4 + r][j] * expf(Ac[t0 + t] - Ac[s0 + s])
                     : 0.0f;
        }
        *reinterpret_cast<float4*>(Ps + s * kLdS + 4 * ty + 32 * i4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float4 pv[2] = {ld4(Ps + s * kLdS + 4 * ty),
                            ld4(Ps + s * kLdS + 4 * ty + 32)};
      float xv[kPC];
#pragma unroll
      for (int j = 0; j < kPC; ++j) xv[j] = Xs[s * kLdP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kPC; ++j)
          acc[i][j] = fmaf(at(pv[i / 4], i % 4), xv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 4 * ty + 32 * (i / 4) + i % 4;
    if (t >= nq) continue;
    float* row = y + (k.row_b + static_cast<int64_t>(k.c0 + t0 + t) * H) * P;
#pragma unroll
    for (int j = 0; j < kPC; ++j) {
      const int p = tx + 16 * j;
      if (p < P) row[p] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------

// Shared row pitch, in bf16 values, of a tile of 16 d columns: 16 bytes
// more, so that the eight rows an ldmatrix reads fall in eight distinct
// bank groups.
__host__ __device__ constexpr int tc_ld(int d) { return 16 * d + 8; }

// Loads a thread issues before it splits and stores any of them, so that
// their latencies overlap (the stores to shared memory may not be moved
// above a later load: the compiler cannot tell the two apart).
constexpr int kBatch = 4;

// Rows [0, kT) of B * decay into shared hi and lo bf16 tiles (row pitch
// ld, columns [0, Wpad)): v = B[r][col] scale[r] in float32 for r < rows
// and col < W, else 0; hi = bf16(v), lo = bf16(v - hi). scale holds kT
// values. vec as load_rows, by 16 bytes through registers.
__device__ __forceinline__ void load_split_rows(bf16* hi, bf16* lo, int ld,
                                                const bf16* __restrict__ src,
                                                int64_t stride, int rows,
                                                int W, int Wpad,
                                                const float* scale,
                                                bool vec) {
  if (vec) {
    const int per_row = Wpad / 8;
    const int total = kT * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      uint4 raw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * blockDim.x;
        const int r = e / per_row;
        const int col = (e - r * per_row) * 8;
        raw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && r < rows && col < W)
          raw[i] = *reinterpret_cast<const uint4*>(src + r * stride + col);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * blockDim.x;
        if (e >= total) continue;
        const int r = e / per_row;
        const int col = (e - r * per_row) * 8;
        const float d = scale[r];
        const __nv_bfloat162* v =
            reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
        uint4 h, l;
        split_bf16(__low2float(v[0]) * d, __high2float(v[0]) * d, h.x, l.x);
        split_bf16(__low2float(v[1]) * d, __high2float(v[1]) * d, h.y, l.y);
        split_bf16(__low2float(v[2]) * d, __high2float(v[2]) * d, h.z, l.z);
        split_bf16(__low2float(v[3]) * d, __high2float(v[3]) * d, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + r * ld + col) = h;
        *reinterpret_cast<uint4*>(lo + r * ld + col) = l;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kT * Wpad; e += blockDim.x) {
      const int r = e / Wpad;
      const int col = e - r * Wpad;
      const float v = r < rows && col < W
                          ? to_f32(src[r * stride + col]) * scale[r]
                          : 0.0f;
      const bf16 h = __float2bfloat16_rn(v);
      hi[r * ld + col] = h;
      lo[r * ld + col] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

// The float32 (P, N) state at src into shared hi and lo bf16 tiles of
// rows [0, Prows) and columns [0, Npad) (row pitch ld); zeros past P and
// N. By float4 where N % 4 == 0.
__device__ __forceinline__ void load_split_state(bf16* hi, bf16* lo, int ld,
                                                 const float* __restrict__ src,
                                                 int P, int N, int Prows,
                                                 int Npad) {
  if (N % 4 == 0) {
    const int per_row = Npad / 4;
    const int total = Prows * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * blockDim.x;
        const int r = e / per_row;
        const int col = (e - r * per_row) * 4;
        v[i] = e < total && r < P && col < N
                   ? ld4(src + static_cast<int64_t>(r) * N + col)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int e = e0 + i * blockDim.x;
        if (e >= total) continue;
        const int r = e / per_row;
        const int col = (e - r * per_row) * 4;
        uint2 h, l;
        split_bf16(v[i].x, v[i].y, h.x, l.x);
        split_bf16(v[i].z, v[i].w, h.y, l.y);
        *reinterpret_cast<uint2*>(hi + r * ld + col) = h;
        *reinterpret_cast<uint2*>(lo + r * ld + col) = l;
      }
    }
  } else {
    for (int e = threadIdx.x; e < Prows * Npad; e += blockDim.x) {
      const int r = e / Npad;
      const int col = e - r * Npad;
      const float v =
          r < P && col < N ? src[static_cast<int64_t>(r) * N + col] : 0.0f;
      const bf16 h = __float2bfloat16_rn(v);
      hi[r * ld + col] = h;
      lo[r * ld + col] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

// Pass 1: dS = x^T (B * decay), rows p, columns n; warp w takes the
// 16-column tiles of n [w kND / 4, (w + 1) kND / 4) and every row, so each
// element of B * decay feeds one warp. kPD, kND: P and N padded to 16 kPD
// and 16 kND (kND a multiple of 4).
template <int kPD, int kND>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_tc_kernel(float* __restrict__ states,
                              float* __restrict__ acum,
                              const bf16* __restrict__ x,
                              const float* __restrict__ dtA,
                              const bf16* __restrict__ Bm, int S, int H,
                              int P, int N, int L, bool vec) {
  constexpr int kLdP = tc_ld(kPD);
  constexpr int kLdN = tc_ld(kND);
  constexpr int kNW = kND / 4;       // n tiles a warp
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ac = reinterpret_cast<float*>(tc_smem);  // kMaxSsdChunk
  float* Dc = Ac + kMaxSsdChunk;                  // kT: a tile's decays
  bf16* Xs = reinterpret_cast<bf16*>(Dc + kT);    // kT x kLdP
  bf16* Bhi = Xs + kT * kLdP;                     // kT x kLdN: B * decay
  bf16* Blo = Bhi + kT * kLdN;                    // kT x kLdN

  const Cell k = cell(S, H, L);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  chunk_cumsum(Ac, dtA + k.row_b + static_cast<int64_t>(k.c0) * H, H, L,
               acum + k.bh * S + k.c0);
  const float a_last = Ac[L - 1];

  float acc[kPD][2 * kNW][4];
#pragma unroll
  for (int mi = 0; mi < kPD; ++mi)
#pragma unroll
    for (int n = 0; n < 2 * kNW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.0f;

  for (int s0 = 0; s0 < L; s0 += kT) {
    const int nk = min(kT, L - s0);
    __syncthreads();  // the previous tile is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_rows(Xs, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
              16 * kPD, vec);
    cp_async_commit();
    if (tid < kT) Dc[tid] = tid < nk ? expf(a_last - Ac[s0 + tid]) : 0.0f;
    __syncthreads();
    load_split_rows(Bhi, Blo, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N,
                    nk, N, 16 * kND, Dc, vec);
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {   // 16 rows of s a step
      // A = x^T (p x s) from x's (s, p) rows, transposed by ldmatrix
      uint32_t a[kPD][4];
#pragma unroll
      for (int mi = 0; mi < kPD; ++mi)
        ldmatrix_x4_trans(a[mi], Xs + (16 * ks + (lane & 7) +
                                       (lane >> 4) * 8) * kLdP +
                                     16 * mi + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < kNW; ++j) {
        uint32_t bh[4], bl[4];
        const int off = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdN +
                        16 * (warp * kNW + j) + (lane >> 4) * 8;
        ldmatrix_x4_trans(bh, Bhi + off);
        ldmatrix_x4_trans(bl, Blo + off);
#pragma unroll
        for (int mi = 0; mi < kPD; ++mi) {
          mma_bf16(acc[mi][2 * j], a[mi], bh[0], bh[1]);
          mma_bf16(acc[mi][2 * j + 1], a[mi], bh[2], bh[3]);
          mma_bf16(acc[mi][2 * j], a[mi], bl[0], bl[1]);
          mma_bf16(acc[mi][2 * j + 1], a[mi], bl[2], bl[3]);
        }
      }
    }
  }

  // element e of fragment n of p tile mi: p = 16 mi + g + 8 (e / 2),
  // n = 16 kNW warp + 8 n + 2 (lane % 4) + e % 2
  float* out = states + (k.bh * (S / L) + k.c) * P * N;
#pragma unroll
  for (int mi = 0; mi < kPD; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * mi + lane / 4 + 8 * (e / 2);
      if (p >= P) continue;
#pragma unroll
      for (int n = 0; n < 2 * kNW; ++n) {
        const int col = 16 * kNW * warp + 8 * n + 2 * (lane % 4) + e % 2;
        if (col < N) out[static_cast<int64_t>(p) * N + col] = acc[mi][n][e];
      }
    }
}

// Pass 3: query tile gridDim.z - 1 - blockIdx.z of the cell's chunk; warp
// w takes its rows 16 w .. 16 w + 15, lane rows g = lane / 4 and g + 8.
// Blocks an SM the y kernel's registers are capped for, as many as its
// shared memory allows: four at P, N <= 64 (47 KB a block), three at P
// <= 64 (72 KB), two above.
template <int kPD, int kND>
constexpr int kYMinBlocks = kPD > 4 ? 2 : kND > 4 ? 3 : 4;

template <int kPD, int kND>
__global__ void __launch_bounds__(kThreads, kYMinBlocks<kPD, kND>)
    ssd_y_tc_kernel(bf16* __restrict__ y, const bf16* __restrict__ x,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ acum,
                    const float* __restrict__ states, int S, int H, int P,
                    int N, int L, bool vec, bool has_init) {
  constexpr int kLdP = tc_ld(kPD);
  constexpr int kLdN = tc_ld(kND);
  constexpr int kStage = kT * (kLdN + kLdP);  // a key tile: B rows, x rows
  static_assert(16 * kPD * kLdN <= kStage, "the state fits in the ring");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ac = reinterpret_cast<float*>(tc_smem);           // kMaxSsdChunk
  bf16* Cs = reinterpret_cast<bf16*>(Ac + kMaxSsdChunk);   // kT x kLdN
  bf16* ring = Cs + kT * kLdN;                             // 2 stages
  // the state's hi and lo parts (16 kPD x kLdN each) use the ring before
  // the first key tile comes in
  bf16* Shi = ring;
  bf16* Slo = ring + kStage;

  const Cell k = cell(S, H, L);
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int t0 = qt * kT;
  const int nq = min(kT, L - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tq = lane % 4;
  const int nc = S / L;

  // key tile kt into its stage of the ring, as one cp.async group
  auto load_keys = [&](int kt) {
    bf16* st = ring + (kt % 2) * kStage;
    const int s0 = kt * kT;
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_rows(st, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N,
              min(kT, L - s0), kT, N, 16 * kND, vec);
    load_rows(st + kT * kLdN, kLdP, x + r0 * P, static_cast<int64_t>(H) * P,
              min(kT, L - s0), kT, P, 16 * kPD, vec);
    cp_async_commit();
  };

  for (int t = tid; t < t0 + nq; t += kThreads)
    Ac[t] = acum[k.bh * S + k.c0 + t];
  load_rows(Cs, kLdN,
            Cm + (k.row_b + static_cast<int64_t>(k.c0 + t0) * H) * N,
            static_cast<int64_t>(H) * N, nq, kT, N, 16 * kND, vec);
  cp_async_commit();
  const bool has_state = k.c > 0 || has_init;
  if (has_state)
    load_split_state(Shi, Slo, kLdN, states + (k.bh * nc + k.c) * P * N, P,
                     N, 16 * kPD, 16 * kND);
  cp_async_wait<0>();
  __syncthreads();

  // this lane's rows of the tile: tl[r] = 16 warp + g + 8 r
  int tl[2];
  bool row_ok[2];
  float a_t[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tl[r] = 16 * warp + lane / 4 + 8 * r;
    row_ok[r] = tl[r] < nq;
    a_t[r] = row_ok[r] ? Ac[t0 + tl[r]] : 0.0f;
  }
  // the warp's 16 rows of C as A fragments, one per 16 columns of N
  uint32_t cf[kND][4];
#pragma unroll
  for (int kk = 0; kk < kND; ++kk)
    ldmatrix_x4(cf[kk], Cs + (16 * warp + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * kLdN +
                            16 * kk + (lane >> 4) * 8);

  float acc[2 * kPD][4];   // 16 rows x 16 kPD columns of y
#pragma unroll
  for (int n = 0; n < 2 * kPD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  if (has_state) {  // exp(A_cum[t]) C[t] . (S_hi + S_lo)
#pragma unroll
    for (int kk = 0; kk < kND; ++kk)
#pragma unroll
      for (int np = 0; np < kPD; ++np) {
        uint32_t sh[4], sl[4];
        const int off = (16 * np + (lane & 7) + (lane >> 4) * 8) * kLdN +
                        16 * kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(sh, Shi + off);
        ldmatrix_x4(sl, Slo + off);
        mma_bf16(acc[2 * np], cf[kk], sh[0], sh[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], sh[2], sh[3]);
        mma_bf16(acc[2 * np], cf[kk], sl[0], sl[1]);
        mma_bf16(acc[2 * np + 1], cf[kk], sl[2], sl[3]);
      }
    const float decay[2] = {row_ok[0] ? expf(a_t[0]) : 0.0f,
                            row_ok[1] ? expf(a_t[1]) : 0.0f};
#pragma unroll
    for (int n = 0; n < 2 * kPD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= decay[e / 2];
    __syncthreads();  // every warp is done with the state in the ring
  }

  load_keys(0);
  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<0>();  // key tile kt is in
    __syncthreads();     // every warp is done with tile kt - 1's stage
    if (kt < qt) load_keys(kt + 1);
    const bf16* Bt = ring + (kt % 2) * kStage;
    const bf16* Xt = Bt + kT * kLdN;
    const int s0 = kt * kT;
    // 16-key column blocks of the tile that some row of the warp sees:
    // on the diagonal only those up to the warp's last row
    const int np_end = kt == qt ? warp + 1 : 4;

    // scores C B^T: 16 rows x 64 keys, eight 8-key fragments
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kND; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np >= np_end) continue;
        uint32_t bf[4];
        ldmatrix_x4(bf, Bt + (16 * np + (lane & 7) + (lane >> 4) * 8) * kLdN +
                            16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], cf[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * np + 1], cf[kk], bf[2], bf[3]);
      }
    // masked and decayed: element e of fragment n is row tl[e / 2], key
    // s0 + 8 n + 2 tq + e % 2. exp(d) as 2^(d log2 e): d is exact for the
    // keys near the row, where the weights are large
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + 8 * n + 2 * tq + e % 2;
        sc[n][e] = row_ok[e / 2] && (kt < qt || s <= t0 + tl[e / 2])
                       ? sc[n][e] * ex2((a_t[e / 2] - Ac[s]) * kLog2e)
                       : 0.0f;
      }
    // y += (P_hi + P_lo) x, 16 keys a step: fragments 2 j and 2 j + 1 of
    // the scores are the A fragment of keys [16 j, 16 j + 16)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= np_end) continue;
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * j][0], sc[2 * j][1], hi[0], lo[0]);
      split_bf16(sc[2 * j][2], sc[2 * j][3], hi[1], lo[1]);
      split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < kPD; ++dp) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, Xt + (16 * j + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kLdP +
                                  16 * dp + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], hi, xf[0], xf[1]);
        mma_bf16(acc[2 * dp + 1], hi, xf[2], xf[3]);
        mma_bf16(acc[2 * dp], lo, xf[0], xf[1]);
        mma_bf16(acc[2 * dp + 1], lo, xf[2], xf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    bf16* row = y + (k.row_b + static_cast<int64_t>(k.c0 + t0 + tl[r]) * H) *
                        P;
#pragma unroll
    for (int n = 0; n < 2 * kPD; ++n) {
      const int p = 8 * n + 2 * tq;
      if (P % 2 == 0) {       // both columns or neither, 4-byte aligned
        if (p < P)
          *reinterpret_cast<__nv_bfloat162*>(row + p) =
              __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        if (p < P) row[p] = __float2bfloat16_rn(acc[n][2 * r]);
        if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(acc[n][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The three passes on `stream`, with the chunk-state and y kernels given
// (and the dynamic shared memory each takes); T is x's type.
template <typename T, typename StateKernel, typename YKernel>
cudaError_t run_passes(StateKernel state_kernel, size_t state_smem,
                       YKernel y_kernel, size_t y_smem, void* y, void* fin,
                       const void* x, const float* dtA, const void* Bm,
                       const void* Cm, const float* init, float* acum,
                       float* states, int64_t B,
                       int64_t S, int64_t H, int64_t P, int64_t N, int64_t L,
                       cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);  // elements a 16-byte chunk
  const bool vec = P % kE == 0 && N % kE == 0 && aligned16(x) &&
                   aligned16(Bm) && aligned16(Cm);
  const int Si = static_cast<int>(S), Hi = static_cast<int>(H),
            Pi = static_cast<int>(P), Ni = static_cast<int>(N),
            Li = static_cast<int>(L);
  const dim3 cells(static_cast<unsigned>(S / L * H),
                   static_cast<unsigned>(B));

  cudaError_t err = cudaFuncSetAttribute(
      state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(state_smem));
  if (err != cudaSuccess) return err;
  state_kernel<<<cells, kThreads, state_smem, stream>>>(
      states, acum, static_cast<const T*>(x), dtA,
      static_cast<const T*>(Bm), Si, Hi, Pi, Ni, Li, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int PN = Pi * Ni;
  ssd_state_pass_kernel<T><<<dim3(static_cast<unsigned>(B * H),
                                  (PN + kPassThreads - 1) / kPassThreads),
                             kPassThreads, 0, stream>>>(
      static_cast<T*>(fin), states, acum, init, Si, Li, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(y_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(y_smem));
  if (err != cudaSuccess) return err;
  const dim3 tiles(cells.x, cells.y,
                   static_cast<unsigned>((L + kT - 1) / kT));
  y_kernel<<<tiles, kThreads, y_smem, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(x),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), acum, states,
      Si, Hi, Pi, Ni, Li, vec, init != nullptr);
  return cudaGetLastError();
}

template <int kPG, int kNG>
cudaError_t launch_simt(void* y, void* fin, const void* x, const float* dtA,
                        const void* Bm, const void* Cm, const float* init,
                        float* acum, float* states, int64_t B, int64_t S,
                        int64_t H,
                        int64_t P, int64_t N, int64_t L,
                        cudaStream_t stream) {
  const size_t state_smem =
      sizeof(float) * (kMaxSsdChunk + kT + kT * simt_ld(kPG) +
                       kT * simt_ld(kNG));
  const size_t y_smem =
      sizeof(float) * (kMaxSsdChunk + kT * simt_ld(kNG) +
                       64 * kPG * simt_ld(kNG) + kT * simt_ld(kPG) +
                       kT * (kT + 4));
  return run_passes<float>(ssd_chunk_state_kernel<kPG, kNG>, state_smem,
                           ssd_y_kernel<kPG, kNG>, y_smem, y, fin, x, dtA,
                           Bm, Cm, init, acum, states, B, S, H, P, N, L,
                           stream);
}

template <int kPD, int kND>
cudaError_t launch_tc(void* y, void* fin, const void* x, const float* dtA,
                      const void* Bm, const void* Cm, const float* init,
                      float* acum, float* states, int64_t B, int64_t S,
                      int64_t H,
                      int64_t P, int64_t N, int64_t L, cudaStream_t stream) {
  const size_t state_smem =
      sizeof(float) * (kMaxSsdChunk + kT) +
      sizeof(bf16) * (kT * tc_ld(kPD) + 2 * kT * tc_ld(kND));
  const size_t y_smem =
      sizeof(float) * kMaxSsdChunk +
      sizeof(bf16) * (kT * tc_ld(kND) + 2 * kT * (tc_ld(kND) + tc_ld(kPD)));
  return run_passes<bf16>(ssd_chunk_state_tc_kernel<kPD, kND>, state_smem,
                          ssd_y_tc_kernel<kPD, kND>, y_smem, y, fin, x, dtA,
                          Bm, Cm, init, acum, states, B, S, H, P, N, L,
                          stream);
}

}  // namespace

cudaError_t launch_ssd_scan(void* y, void* final_state, const void* x,
                            const float* dtA, const void* B_, const void* C_,
                            const float* initial_state, float* acum,
                            float* states, int64_t B, int64_t S, int64_t H,
                            int64_t P, int64_t N, int64_t L, bool bf16,
                            cudaStream_t stream) {
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
#define REPRO_SSD(LAUNCH, PG, NG)                                       \
  return LAUNCH<PG, NG>(y, final_state, x, dtA, B_, C_, initial_state,    \
                        acum, states, B, S, H, P, N, L, stream)
  if (bf16) {   // P and N padded to 64 or 128, in 16-column fragments
    if (P <= 64 && N <= 64) REPRO_SSD(launch_tc, 4, 4);
    if (P <= 64) REPRO_SSD(launch_tc, 4, 8);
    if (N <= 64) REPRO_SSD(launch_tc, 8, 4);
    REPRO_SSD(launch_tc, 8, 8);
  }
  if (P <= 64 && N <= 64) REPRO_SSD(launch_simt, 1, 1);
  if (P <= 64) REPRO_SSD(launch_simt, 1, 2);
  if (N <= 64) REPRO_SSD(launch_simt, 2, 1);
  REPRO_SSD(launch_simt, 2, 2);
#undef REPRO_SSD
}
