// The backward of the Mamba-2 SSD chunked scan (ssd_scan.cu) for Hopper
// (sm_90a), float32 math for float32 and bf16 operands.
//
// Replaces no TPU kernel: repro/kernels/ssd_scan.py:ssd_scan has no
// backward (the JAX package trains through its jnp ssd_chunked, and
// jax.vjp of it is what this computes). Per (b, h) and chunk c of L rows,
// with a the chunk's cumulative sum of dtA, a_L its last, S_c the state
// the chunk starts from (the forward's float32 `states`), W[t, s] =
// exp(a_t - a_s) for s <= t, G = C B^T, D = dy x^T and R = R_{c+1} the
// adjoint of the state the chunk ends with:
//   R_c  = exp(a_L) R_{c+1} + sum_t exp(a_t) dy_t^T C_t, R_nc = dfinal
//   dx_s = sum_t (W G)[t, s] dy_t + exp(a_L - a_s) R B_s
//   dB_s = sum_t (W D)[t, s] C_t + exp(a_L - a_s) R^T x_s
//   dC_t = sum_s (W D)[t, s] B_s + exp(a_t) S_c^T dy_t
//   da_t = rowsum_t(W G D) - colsum_t(W G D) + C_t . w_t - q_t
//          (+ exp(a_L) <R, S_c> + sum_s q_s at t = L - 1)
//   ddtA_s = sum_{t >= s} da_t
// where w_t = exp(a_t) S_c^T dy_t and q_s = x_s . (exp(a_L - a_s) R B_s).
// The TPU's sequential chunk axis becomes passes spread across the card,
// as in the forward; no pass carries anything between blocks, and there
// are no atomics (every sum is taken in one order: the same bits every
// run):
//   1. per (b, h, chunk): the chunk's cumulative sum of dtA (into the f32
//      scratch `acum`, (B, H, S)) and its own term sum_t exp(a_t) dy_t^T
//      C_t, (P, N), into the f32 scratch `adj`, (B, H, chunks, P, N);
//   2. the adjoint's recurrence over the chunks in reverse, one thread per
//      (b, h, p, n), writing over chunk c's own term the R_{c+1} it needs
//      and writing dinitial = R_0;
//   3. per (b, h, chunk, 64-row key tile): dx and dB of its rows, the
//      column sums of W G D and q (two f32 scratch rows, (B, H, S)); the
//      query tiles at and after the key tile, one at a time;
//   4. per (b, h, chunk, 64-row query tile): dC of its rows and the row
//      sums of W G D plus C_t . w_t (and, on the tile of row L - 1,
//      exp(a_L) <R, S_c>), into a third f32 scratch row; the key tiles up
//      to the diagonal, one at a time;
//   5. per (b, h, chunk): da from the three scratch rows, and its reverse
//      cumulative sum into ddtA.
// Passes 3 and 4 each recompute G and D for their tile pairs (flash
// attention's backward splits its two sides the same way). The heaviest
// tiles (the most partner tiles) are launched first.
//
// bf16 operands whose P and N are multiples of 8 and whose rows are
// 16-byte aligned (the training path) run passes 3 and 4 on the tensor
// cores: mma.sync m16n8k16 with bf16 fragments by ldmatrix
// (tensor_core.cuh), float32 accumulators, four warps a block, warp w
// owning rows 16 w .. 16 w + 15 of the tile. As in the forward, only
// products of two bf16 values go to the tensor cores as they are (G =
// C B^T and D = dy x^T); a float32 operand (the masked scores W G and
// W D, R and S_c) goes as hi = bf16(v) and lo = bf16(v - hi), the two
// products summed in float32. The score tile's 64 columns are taken 32
// at a time, which keeps the scores and both output tiles in registers.
//
// Everything else (passes 1, 2 and 5; float32 operands, the card-against-
// CPU checks; other P, N or alignments) runs on the SIMT units, 256
// threads a block: tiles go into shared memory as float32 rows (bf16
// converted on the way in, zeros past the edges, so P and N that are not
// multiples of 16 and a chunk that is not a multiple of 64 take the same
// path), and thread (ty, tx) = (tid / 16, tid % 16) keeps the rows 4 ty
// .. 4 ty + 3 of a 64-row output tile and its columns tx + 16 j in
// registers. Three shared-memory products feed them: four-wide dot
// products along the rows of both operands (G, D, and the state terms R
// B_s), a sum over the rows of both (the masked scores times dy, C or B,
// and the chunk's own adjoint term), and a row of one times the columns
// of the other (R^T x_s, S_c^T dy_t). Row pitches are 64 g + 4 floats, so
// that consecutive rows start one 16-byte bank group apart.
//
// What bounds it: at mamba2-130m's training shape (B 8, S 1024, H 24, P
// 64, N 128, L 256, bf16) the operands and outputs are 303.6 MB (0.091
// ms at 3.35 TB/s); the L x L products, L^2 (3 N + 2 P) multiply-adds a
// chunk and head, and the state products are 64.4 GFLOP (0.065 ms at the
// bf16 tensor rate, before the hi + lo splits double the float32
// operands' share). So bytes bound it. On an H100 SXM at 700 W the SIMT
// kernels alone took 6.06 ms there (as long as the plain version, 16% of
// the float32 units' peak); with passes 3 and 4 on the tensor cores a
// call takes 1.49 ms, ~16x its bound: the key-tile kernel holds 255
// registers (the scores, dx and dB of a warp's 16 rows) and spills a few
// bytes, and pass 1 (the chunk's own adjoint term) stays on the SIMT
// units.

#include "model_dtype.cuh"
#include "model_ops.h"
#include "tensor_core.cuh"

namespace {

constexpr int kT = 64;          // rows of a key, query or chunk tile
constexpr int kThreads = 256;   // the SIMT kernels
constexpr int kTcThreads = 128; // the tensor-core kernels: four warps
constexpr int kLdM = kT + 4;    // pitch of a 64 x 64 score tile

// Shared row pitch, in floats, of a tile of 64 g columns.
__host__ __device__ constexpr int ld_of(int g) { return 64 * g + 4; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Sum over the 16 lanes of a half warp (the threads that share ty).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [0, tile_rows) and columns [0, Wpad) of a float32 shared tile (row
// pitch ld): src[r * stride + col] (times scale[r] when given) for r <
// rows and col < W, zeros elsewhere.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int rows,
                                          int tile_rows, int W, int Wpad,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < tile_rows * Wpad; e += blockDim.x) {
    const int r = e / Wpad;
    const int col = e - r * Wpad;
    float v = 0.0f;
    if (r < rows && col < W) {
      v = to_f32(src[r * stride + col]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld + col] = v;
  }
}

// acc[r][j] += sum_k A[4 ty + r][k] B[tx + 16 j][k], k < K (a multiple
// of 4): dot products along the rows of both.
template <int kC>
__device__ __forceinline__ void mm_dot(float (&acc)[4][kC], const float* A,
                                       int lda, const float* B, int ldb,
                                       int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (4 * ty + r) * lda + k);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float4 b = ld4(B + (tx + 16 * j) * ldb + k);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][j] = dot4(a[r], b, acc[r][j]);
    }
  }
}

// acc[r][j] += sum_k A[k][4 ty + r] B[k][tx + 16 j], k < K: a sum over
// the rows of both.
template <int kC>
__device__ __forceinline__ void mm_tn(float (&acc)[4][kC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < K; ++k) {
    const float4 a = ld4(A + k * lda + 4 * ty);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float b = B[k * ldb + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(at(a, r), b, acc[r][j]);
    }
  }
}

// acc[r][j] += sum_k A[4 ty + r][k] B[k][tx + 16 j], k < K (a multiple
// of 4): the rows of A times the columns of B.
template <int kC>
__device__ __forceinline__ void mm_nn(float (&acc)[4][kC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (4 * ty + r) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float b = B[(k + kk) * ldb + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r][j] = fmaf(at(a[r], kk), b, acc[r][j]);
      }
  }
}

template <int kC>
__device__ __forceinline__ void zero(float (&acc)[4][kC]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[r][j] = 0.0f;
}

// acc's rows t0 + 4 ty + r < rows (row pitch stride) and columns tx + 16
// j < W of dst, in T.
template <typename T, int kC>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           int64_t stride, int rows, int W,
                                           const float (&acc)[4][kC]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ty + r;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int col = tx + 16 * j;
      if (col < W) dst[row * stride + col] = from_f32<T>(acc[r][j]);
    }
  }
}

// The scan's (b, h, chunk) of a block: blockIdx.x = h * chunks + c,
// blockIdx.y = b.
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
// pass 1: the chunk's cumulative sum and its own term of the adjoint
// ------------------------------------------------------------------------

template <typename T, int kPG, int kNG>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_local_kernel(float* __restrict__ adj, float* __restrict__ acum,
                         const T* __restrict__ dy, const T* __restrict__ Cm,
                         const float* __restrict__ dtA, int S, int H, int P,
                         int N, int L) {
  constexpr int kLdP = ld_of(kPG), kLdN = ld_of(kNG);
  extern __shared__ __align__(16) float smem[];
  float* Ac = smem;                 // kMaxSsdChunk: the chunk's a
  float* Ea = Ac + kMaxSsdChunk;    // kMaxSsdChunk: exp(a)
  float* Ys = Ea + kMaxSsdChunk;    // kT x kLdP: dy rows
  float* Cs = Ys + kT * kLdP;       // kT x kLdN: C rows times exp(a)
  const Cell k = cell(S, H, L);
  const int tid = threadIdx.x;

  // the inclusive cumulative sum of dtA over the chunk: the first warp
  // takes a run of rows a lane, then a shuffle scan of the lane totals
  const float* dA = dtA + k.row_b + static_cast<int64_t>(k.c0) * H;
  for (int t = tid; t < L; t += kThreads)
    Ac[t] = dA[t * static_cast<int64_t>(H)];
  __syncthreads();
  if (tid < 32) {
    const int per = (L + 31) / 32;
    const int lo = tid * per;
    float run = 0.0f;
    for (int i = 0; i < per && lo + i < L; ++i) {
      run += Ac[lo + i];
      Ac[lo + i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    for (int i = 0; i < per && lo + i < L; ++i) Ac[lo + i] += incl - run;
  }
  __syncthreads();
  for (int t = tid; t < L; t += kThreads) {
    acum[k.bh * S + k.c0 + t] = Ac[t];
    Ea[t] = expf(Ac[t]);
  }

  // adj[p][n] = sum_t dy[t][p] exp(a_t) C[t][n], p in 64-row blocks
  float acc[kPG][4][4 * kNG];
#pragma unroll
  for (int pb = 0; pb < kPG; ++pb) zero(acc[pb]);
  for (int s0 = 0; s0 < L; s0 += kT) {
    const int nk = min(kT, L - s0);
    __syncthreads();  // Ea is written; the previous tile is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_tile(Ys, kLdP, dy + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
              64 * kPG);
    load_tile(Cs, kLdN, Cm + r0 * N, static_cast<int64_t>(H) * N, nk, kT, N,
              64 * kNG, Ea + s0);
    __syncthreads();
#pragma unroll
    for (int pb = 0; pb < kPG; ++pb)
      mm_tn(acc[pb], Ys + 64 * pb, kLdP, Cs, kLdN, kT);
  }
  float* out = adj + (k.bh * (S / L) + k.c) * P * N;
#pragma unroll
  for (int pb = 0; pb < kPG; ++pb)
    store_tile<float>(out + static_cast<int64_t>(64 * pb) * N, N, P - 64 * pb,
                      N, acc[pb]);
}

// ------------------------------------------------------------------------
// pass 2: the adjoint's recurrence over the chunks, in reverse;
// blockIdx.x = b * H + h, a thread one element of the (P, N) state
// ------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_pass_kernel(float* __restrict__ dinit,
                              float* __restrict__ adj,
                              const float* __restrict__ acum,
                              const float* __restrict__ dfinal, int S,
                              int L, int PN) {
  const int64_t bh = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int nc = S / L;
  float* st = adj + bh * nc * PN + e;
  const float* a_last = acum + bh * S + L - 1;
  float R = dfinal != nullptr ? dfinal[bh * PN + e] : 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const float own = st[static_cast<int64_t>(c) * PN];
    st[static_cast<int64_t>(c) * PN] = R;
    R = expf(a_last[static_cast<int64_t>(c) * L]) * R + own;
  }
  dinit[bh * PN + e] = R;
}

// ------------------------------------------------------------------------
// pass 3: key tile blockIdx.z of the cell's chunk: dx, dB, the column
// sums of W G D and q
// ------------------------------------------------------------------------

template <typename T, int kPG, int kNG>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_key_kernel(T* __restrict__ dx, T* __restrict__ dB,
                       float* __restrict__ dcol, float* __restrict__ qrow,
                       const T* __restrict__ x, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, const T* __restrict__ dy,
                       const float* __restrict__ acum,
                       const float* __restrict__ adj, int S, int H, int P,
                       int N, int L) {
  constexpr int kLdP = ld_of(kPG), kLdN = ld_of(kNG);
  extern __shared__ __align__(16) float smem[];
  float* Ac = smem;                  // kMaxSsdChunk
  float* Xs = Ac + kMaxSsdChunk;     // kT x kLdP: the key tile's x
  float* Bs = Xs + kT * kLdP;        // kT x kLdN: its B
  float* Cq = Bs + kT * kLdN;        // kT x kLdN: a query tile's C, and
  float* Yq = Cq + kT * kLdN;        // kT x kLdP: its dy; R before them
  float* Rs = Cq;                    // 64 kPG x kLdN (fits: see launcher)
  float* M1 = Yq + kT * kLdP;        // kT x kLdM: (W G)[t][s]
  float* M2 = M1 + kT * kLdM;        // kT x kLdM: (W D)[t][s]

  const Cell k = cell(S, H, L);
  const int ks = blockIdx.z;
  const int s0 = ks * kT;
  const int nk = min(kT, L - s0);
  const int nqt = (L + kT - 1) / kT;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int t = tid; t < L; t += kThreads) Ac[t] = acum[k.bh * S + k.c0 + t];
  const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
  load_tile(Xs, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
            64 * kPG);
  load_tile(Bs, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, kT, N,
            64 * kNG);
  load_tile(Rs, kLdN, adj + (k.bh * (S / L) + k.c) * P * N,
            static_cast<int64_t>(N), P, 64 * kPG, N, 64 * kNG);
  __syncthreads();

  // the state terms: exp(a_L - a_s) (R B_s, R^T x_s), and q_s
  const float a_L = Ac[L - 1];
  float e_end[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    e_end[r] = 4 * ty + r < nk ? expf(a_L - Ac[s0 + 4 * ty + r]) : 0.0f;
  float gx[4][4 * kPG], gb[4][4 * kNG];
  zero(gx);
  zero(gb);
  mm_dot(gx, Bs, kLdN, Rs, kLdN, 64 * kNG);
  mm_nn(gb, Xs, kLdP, Rs, kLdN, 64 * kPG);
  float col[4], q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float qs = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * kPG; ++j) {
      gx[r][j] *= e_end[r];
      qs = fmaf(Xs[(4 * ty + r) * kLdP + tx + 16 * j], gx[r][j], qs);
    }
#pragma unroll
    for (int j = 0; j < 4 * kNG; ++j) gb[r][j] *= e_end[r];
    q[r] = sum16(qs);
    col[r] = 0.0f;
  }

  for (int qt = ks; qt < nqt; ++qt) {
    const int t0 = qt * kT;
    const int nq = min(kT, L - t0);
    __syncthreads();  // R, or the previous query tile, is consumed
    const int64_t q0 = k.row_b + static_cast<int64_t>(k.c0 + t0) * H;
    load_tile(Cq, kLdN, Cm + q0 * N, static_cast<int64_t>(H) * N, nq, kT, N,
              64 * kNG);
    load_tile(Yq, kLdP, dy + q0 * P, static_cast<int64_t>(H) * P, nq, kT, P,
              64 * kPG);
    __syncthreads();
    // G^T[s][t] and D^T[s][t], rows s = 4 ty + r, columns t = tx + 16 j
    float g[4][4], d[4][4];
    zero(g);
    zero(d);
    mm_dot(g, Bs, kLdN, Cq, kLdN, 64 * kNG);
    mm_dot(d, Xs, kLdP, Yq, kLdP, 64 * kPG);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tx + 16 * j;
      float m1[4], m2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = 4 * ty + r;
        const bool seen = s < nk && t < nq && t0 + t >= s0 + s;
        const float w = seen ? expf(Ac[t0 + t] - Ac[s0 + s]) : 0.0f;
        m1[r] = w * g[r][j];
        m2[r] = w * d[r][j];
        col[r] = fmaf(m1[r], d[r][j], col[r]);
      }
      *reinterpret_cast<float4*>(M1 + t * kLdM + 4 * ty) =
          make_float4(m1[0], m1[1], m1[2], m1[3]);
      *reinterpret_cast<float4*>(M2 + t * kLdM + 4 * ty) =
          make_float4(m2[0], m2[1], m2[2], m2[3]);
    }
    __syncthreads();
    mm_tn(gx, M1, kLdM, Yq, kLdP, nq);   // dx_s += sum_t (W G)[t][s] dy_t
    mm_tn(gb, M2, kLdM, Cq, kLdN, nq);   // dB_s += sum_t (W D)[t][s] C_t
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float c = sum16(col[r]);
    const int s = 4 * ty + r;
    if (tx == 0 && s < nk) {
      dcol[k.bh * S + k.c0 + s0 + s] = c;
      qrow[k.bh * S + k.c0 + s0 + s] = q[r];
    }
  }
  store_tile<T>(dx + r0 * P, static_cast<int64_t>(H) * P, nk, P, gx);
  store_tile<T>(dB + r0 * N, static_cast<int64_t>(H) * N, nk, N, gb);
}

// ------------------------------------------------------------------------
// pass 4: query tile gridDim.z - 1 - blockIdx.z of the cell's chunk: dC
// and the row sums of W G D plus C_t . w_t
// ------------------------------------------------------------------------

template <typename T, int kPG, int kNG>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_query_kernel(T* __restrict__ dC, float* __restrict__ drow,
                         const T* __restrict__ x, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const T* __restrict__ dy,
                         const float* __restrict__ acum,
                         const float* __restrict__ states,
                         const float* __restrict__ adj, int S, int H, int P,
                         int N, int L) {
  constexpr int kLdP = ld_of(kPG), kLdN = ld_of(kNG);
  extern __shared__ __align__(16) float smem[];
  float* Ac = smem;                  // kMaxSsdChunk
  float* Cs = Ac + kMaxSsdChunk;     // kT x kLdN: the query tile's C
  float* Ys = Cs + kT * kLdN;        // kT x kLdP: its dy
  float* Bk = Ys + kT * kLdP;        // kT x kLdN: a key tile's B, and
  float* Xk = Bk + kT * kLdN;        // kT x kLdP: its x; S_c before them
  float* Ss = Bk;                    // 64 kPG x kLdN
  float* M2 = Xk + kT * kLdP;        // kT x kLdM: (W D)[s][t]
  float* red = M2 + kT * kLdM;       // kThreads / 32: a block sum

  const Cell k = cell(S, H, L);
  const int nqt = gridDim.z;
  const int qt = nqt - 1 - blockIdx.z;
  const int t0 = qt * kT;
  const int nq = min(kT, L - t0);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int64_t cell_state = (k.bh * (S / L) + k.c) * P * N;

  for (int t = tid; t < L; t += kThreads) Ac[t] = acum[k.bh * S + k.c0 + t];
  const int64_t q0 = k.row_b + static_cast<int64_t>(k.c0 + t0) * H;
  load_tile(Cs, kLdN, Cm + q0 * N, static_cast<int64_t>(H) * N, nq, kT, N,
            64 * kNG);
  load_tile(Ys, kLdP, dy + q0 * P, static_cast<int64_t>(H) * P, nq, kT, P,
            64 * kPG);
  load_tile(Ss, kLdN, states + cell_state, static_cast<int64_t>(N), P,
            64 * kPG, N, 64 * kNG);
  __syncthreads();

  // w_t = exp(a_t) S_c^T dy_t, the start of dC; C_t . w_t into the rows
  float gc[4][4 * kNG];
  zero(gc);
  mm_nn(gc, Ys, kLdP, Ss, kLdN, 64 * kPG);
  float row[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = 4 * ty + r;
    const float e = t < nq ? expf(Ac[t0 + t]) : 0.0f;
    float cw = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * kNG; ++j) {
      gc[r][j] *= e;
      cw = fmaf(Cs[t * kLdN + tx + 16 * j], gc[r][j], cw);
    }
    row[r] = cw;
  }
  // on the tile of row L - 1: exp(a_L) <R_{c+1}, S_c>, a block sum
  float end_term = 0.0f;
  if (t0 + nq == L) {
    const float* R = adj + cell_state;
    float part = 0.0f;
    for (int e = tid; e < P * N; e += kThreads)
      part = fmaf(R[e], Ss[(e / N) * kLdN + e % N], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % 32 == 0) red[tid / 32] = part;
    __syncthreads();
    for (int i = 0; i < kThreads / 32; ++i) end_term += red[i];
    end_term *= expf(Ac[L - 1]);
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int s0 = kt * kT;
    const int nk = min(kT, L - s0);
    __syncthreads();  // S_c, or the previous key tile, is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_tile(Bk, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, kT, N,
              64 * kNG);
    load_tile(Xk, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, kT, P,
              64 * kPG);
    __syncthreads();
    // G[t][s] and D[t][s], rows t = 4 ty + r, columns s = tx + 16 j
    float g[4][4], d[4][4];
    zero(g);
    zero(d);
    mm_dot(g, Cs, kLdN, Bk, kLdN, 64 * kNG);
    mm_dot(d, Ys, kLdP, Xk, kLdP, 64 * kPG);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tx + 16 * j;
      float m2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * ty + r;
        const bool seen = t < nq && s < nk && t0 + t >= s0 + s;
        const float w = seen ? expf(Ac[t0 + t] - Ac[s0 + s]) : 0.0f;
        row[r] = fmaf(w * g[r][j], d[r][j], row[r]);
        m2[r] = w * d[r][j];
      }
      *reinterpret_cast<float4*>(M2 + s * kLdM + 4 * ty) =
          make_float4(m2[0], m2[1], m2[2], m2[3]);
    }
    __syncthreads();
    mm_tn(gc, M2, kLdM, Bk, kLdN, nk);   // dC_t += sum_s (W D)[t][s] B_s
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = sum16(row[r]);
    const int t = 4 * ty + r;
    if (tx == 0 && t < nq)
      drow[k.bh * S + k.c0 + t0 + t] =
          t0 + t == L - 1 ? v + end_term : v;
  }
  store_tile<T>(dC + q0 * N, static_cast<int64_t>(H) * N, nq, N, gc);
}

// ------------------------------------------------------------------------
// passes 3 and 4 for bf16 operands: tensor cores
// ------------------------------------------------------------------------
//
// The same arithmetic on mma.sync m16n8k16 (bf16 in, float32 accumulate),
// four warps a block, warp w owning rows 16 w .. 16 w + 15 of the tile.
// As in the forward, only products of bf16 values go to the tensor cores
// as they are (G = C B^T and D = dy x^T: each product exact in float32);
// a float32 operand (the masked scores W G and W D, R and S_c) goes as
// hi = bf16(v) and lo = bf16(v - hi), the two products summed in float32.
// A score tile's 64 columns are taken 32 at a time, so that the scores
// and the two output accumulators stay in registers.

using bf16 = __nv_bfloat16;

// Shared row pitch, in bf16 values, of a tile of 16 d columns: 16 bytes
// more, so that the eight rows an ldmatrix reads fall in eight distinct
// bank groups.
__host__ __device__ constexpr int tc_ld(int d) { return 16 * d + 8; }

// A fragment (16 x 16) of a row-major [row][k] tile: rows r0.., k0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                     (lane >> 4) * 8);
}

// B fragments (16 k x 16 n: b[0..1] columns n0.., b[2..3] n0 + 8..) of a
// tile stored [n][k]
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* t,
                                          int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// ... and of a tile stored [k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* t,
                                          int ld, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// acc[2 j], acc[2 j + 1] += a * (16 x 16 block of b)
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The accumulators of 16 rows x 16 columns (two n8 fragments) as the hi
// and lo A fragments of the next product, whose k runs over those columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&hi)[4],
                                         uint32_t (&lo)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Rows [0, 64) of a bf16 tile (pitch ld, columns [0, Wpad)) from src[r *
// stride + col] for r < rows and col < W, zeros elsewhere, by 16 bytes (W
// a multiple of 8, every row 16-byte aligned).
__device__ __forceinline__ void load_tc_tile(bf16* dst, int ld,
                                             const bf16* __restrict__ src,
                                             int64_t stride, int rows, int W,
                                             int Wpad) {
  const int per_row = Wpad / 8;
  for (int e = threadIdx.x; e < kT * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int col = (e - r * per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < W)
      v = *reinterpret_cast<const uint4*>(src + r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = v;
  }
}

// The float32 (P, N) state at src into shared hi and lo bf16 tiles of rows
// [0, Prows) and columns [0, Npad), zeros past P and N (N % 4 == 0).
__device__ __forceinline__ void load_split_state(bf16* hi, bf16* lo, int ld,
                                                 const float* __restrict__ src,
                                                 int P, int N, int Prows,
                                                 int Npad) {
  const int per_row = Npad / 4;
  for (int e = threadIdx.x; e < Prows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int col = (e - r * per_row) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < P && col < N)
      v = ld4(src + static_cast<int64_t>(r) * N + col);
    uint2 h, l;
    split_bf16(v.x, v.y, h.x, l.x);
    split_bf16(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * ld + col) = h;
    *reinterpret_cast<uint2*>(lo + r * ld + col) = l;
  }
}

// Sum over the four lanes of a row (lane % 4).
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows 16 w + g and + 8 of an output tile in bf16 (row pitch stride, row
// limit rows, columns < W, W even) from acc[2 kD][4].
template <int kD>
__device__ __forceinline__ void store_tc_rows(bf16* __restrict__ dst,
                                              int64_t stride, int rows,
                                              int W,
                                              const float (&acc)[2 * kD][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + lane / 4 + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      if (col < W)
        *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + col) =
            __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// Pass 3 on the tensor cores: key tile blockIdx.z of the cell's chunk.
template <int kPD, int kND>
__global__ void __launch_bounds__(kTcThreads)
    ssd_bwd_key_tc_kernel(bf16* __restrict__ dx, bf16* __restrict__ dB,
                          float* __restrict__ dcol, float* __restrict__ qrow,
                          const bf16* __restrict__ x,
                          const bf16* __restrict__ Bm,
                          const bf16* __restrict__ Cm,
                          const bf16* __restrict__ dy,
                          const float* __restrict__ acum,
                          const float* __restrict__ adj, int S, int H, int P,
                          int N, int L) {
  constexpr int kLdP = tc_ld(kPD), kLdN = tc_ld(kND);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ac = reinterpret_cast<float*>(tc_smem);            // kMaxSsdChunk
  bf16* Xs = reinterpret_cast<bf16*>(Ac + kMaxSsdChunk);    // kT x kLdP
  bf16* Bs = Xs + kT * kLdP;                                // kT x kLdN
  bf16* Cq = Bs + kT * kLdN;                                // kT x kLdN
  bf16* Yq = Cq + kT * kLdN;                                // kT x kLdP
  bf16* Rhi = Yq + kT * kLdP;                               // 16 kPD x kLdN
  bf16* Rlo = Rhi + 16 * kPD * kLdN;

  const Cell k = cell(S, H, L);
  const int ks = blockIdx.z;
  const int s0 = ks * kT;
  const int nk = min(kT, L - s0);
  const int nqt = (L + kT - 1) / kT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;

  for (int t = tid; t < L; t += blockDim.x) Ac[t] = acum[k.bh * S + k.c0 + t];
  const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
  load_tc_tile(Xs, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, P,
               16 * kPD);
  load_tc_tile(Bs, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, N,
               16 * kND);
  load_split_state(Rhi, Rlo, kLdN, adj + (k.bh * (S / L) + k.c) * P * N, P,
                   N, 16 * kPD, 16 * kND);
  __syncthreads();

  // this lane's rows of the tile: sl[h] = 16 warp + g + 8 h
  int sl[2];
  float e_end[2], a_s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sl[h] = 16 * warp + lane / 4 + 8 * h;
    a_s[h] = sl[h] < nk ? Ac[s0 + sl[h]] : 0.0f;
    e_end[h] = sl[h] < nk ? expf(Ac[L - 1] - a_s[h]) : 0.0f;
  }

  // the state terms: gx = exp(a_L - a_s) B_s R^T (rows s, columns p) and
  // gb = exp(a_L - a_s) x_s R (rows s, columns n)
  float gx[2 * kPD][4], gb[2 * kND][4];
#pragma unroll
  for (int n = 0; n < 2 * kPD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gx[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 2 * kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gb[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kND; ++kk) {
    uint32_t a[4];
    frag_a(a, Bs, kLdN, 16 * warp, 16 * kk);
#pragma unroll
    for (int np = 0; np < kPD; ++np) {
      uint32_t bh[4], bl[4];
      frag_b_nk(bh, Rhi, kLdN, 16 * np, 16 * kk);
      frag_b_nk(bl, Rlo, kLdN, 16 * np, 16 * kk);
      mma_pair(gx[2 * np], gx[2 * np + 1], a, bh);
      mma_pair(gx[2 * np], gx[2 * np + 1], a, bl);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kPD; ++kk) {
    uint32_t a[4];
    frag_a(a, Xs, kLdP, 16 * warp, 16 * kk);
#pragma unroll
    for (int nn = 0; nn < kND; ++nn) {
      uint32_t bh[4], bl[4];
      frag_b_kn(bh, Rhi, kLdN, 16 * kk, 16 * nn);
      frag_b_kn(bl, Rlo, kLdN, 16 * kk, 16 * nn);
      mma_pair(gb[2 * nn], gb[2 * nn + 1], a, bh);
      mma_pair(gb[2 * nn], gb[2 * nn + 1], a, bl);
    }
  }
  // scaled by the rows' decays; q_s = x_s . gx_s
  float q[2] = {0.0f, 0.0f}, col[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 2 * kPD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gx[n][e] *= e_end[e / 2];
      const int p = 8 * n + 2 * tq + e % 2;
      q[e / 2] = fmaf(__bfloat162float(Xs[sl[e / 2] * kLdP + p]), gx[n][e],
                      q[e / 2]);
    }
#pragma unroll
  for (int n = 0; n < 2 * kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gb[n][e] *= e_end[e / 2];

  for (int qt = ks; qt < nqt; ++qt) {
    const int t0 = qt * kT;
    const int nq = min(kT, L - t0);
    __syncthreads();  // the previous query tile is consumed
    const int64_t q0 = k.row_b + static_cast<int64_t>(k.c0 + t0) * H;
    load_tc_tile(Cq, kLdN, Cm + q0 * N, static_cast<int64_t>(H) * N, nq, N,
                 16 * kND);
    load_tc_tile(Yq, kLdP, dy + q0 * P, static_cast<int64_t>(H) * P, nq, P,
                 16 * kPD);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;   // the tile's query columns c0 .. c0 + 31
      // G^T and D^T: rows s, columns t
      float g[4][4], d[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[n][e] = d[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t a[4], b0[4], b1[4];
        frag_a(a, Bs, kLdN, 16 * warp, 16 * kk);
        frag_b_nk(b0, Cq, kLdN, c0, 16 * kk);
        frag_b_nk(b1, Cq, kLdN, c0 + 16, 16 * kk);
        mma_pair(g[0], g[1], a, b0);
        mma_pair(g[2], g[3], a, b1);
      }
#pragma unroll
      for (int kk = 0; kk < kPD; ++kk) {
        uint32_t a[4], b0[4], b1[4];
        frag_a(a, Xs, kLdP, 16 * warp, 16 * kk);
        frag_b_nk(b0, Yq, kLdP, c0, 16 * kk);
        frag_b_nk(b1, Yq, kLdP, c0 + 16, 16 * kk);
        mma_pair(d[0], d[1], a, b0);
        mma_pair(d[2], d[3], a, b1);
      }
      // masked and decayed: g <- W G, d <- W D; the column sums of W G D
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = c0 + 8 * n + 2 * tq + e % 2;
          const int sr = sl[e / 2];
          const bool seen = t < nq && sr < nk && t0 + t >= s0 + sr;
          const float w = seen ? expf(Ac[t0 + t] - a_s[e / 2]) : 0.0f;
          g[n][e] *= w;
          col[e / 2] = fmaf(g[n][e], d[n][e], col[e / 2]);
          d[n][e] *= w;
        }
      // dx += (W G)^T dy, dB += (W D)^T C, 16 query rows a step
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t hi[4], lo[4];
        acc_to_a(hi, lo, g[2 * j], g[2 * j + 1]);
#pragma unroll
        for (int dp = 0; dp < kPD; ++dp) {
          uint32_t b[4];
          frag_b_kn(b, Yq, kLdP, c0 + 16 * j, 16 * dp);
          mma_pair(gx[2 * dp], gx[2 * dp + 1], hi, b);
          mma_pair(gx[2 * dp], gx[2 * dp + 1], lo, b);
        }
        acc_to_a(hi, lo, d[2 * j], d[2 * j + 1]);
#pragma unroll
        for (int nn = 0; nn < kND; ++nn) {
          uint32_t b[4];
          frag_b_kn(b, Cq, kLdN, c0 + 16 * j, 16 * nn);
          mma_pair(gb[2 * nn], gb[2 * nn + 1], hi, b);
          mma_pair(gb[2 * nn], gb[2 * nn + 1], lo, b);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float c = sum4(col[h]);
    const float qs = sum4(q[h]);
    if (tq == 0 && sl[h] < nk) {
      dcol[k.bh * S + k.c0 + s0 + sl[h]] = c;
      qrow[k.bh * S + k.c0 + s0 + sl[h]] = qs;
    }
  }
  store_tc_rows<kPD>(dx + r0 * P, static_cast<int64_t>(H) * P, nk, P, gx);
  store_tc_rows<kND>(dB + r0 * N, static_cast<int64_t>(H) * N, nk, N, gb);
}

// Pass 4 on the tensor cores: query tile gridDim.z - 1 - blockIdx.z.
template <int kPD, int kND>
__global__ void __launch_bounds__(kTcThreads)
    ssd_bwd_query_tc_kernel(bf16* __restrict__ dC, float* __restrict__ drow,
                            const bf16* __restrict__ x,
                            const bf16* __restrict__ Bm,
                            const bf16* __restrict__ Cm,
                            const bf16* __restrict__ dy,
                            const float* __restrict__ acum,
                            const float* __restrict__ states,
                            const float* __restrict__ adj, int S, int H,
                            int P, int N, int L) {
  constexpr int kLdP = tc_ld(kPD), kLdN = tc_ld(kND);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ac = reinterpret_cast<float*>(tc_smem);            // kMaxSsdChunk
  float* red = Ac + kMaxSsdChunk;                           // 4: a block sum
  bf16* Cs = reinterpret_cast<bf16*>(red + 4);              // kT x kLdN
  bf16* Ys = Cs + kT * kLdN;                                // kT x kLdP
  bf16* Bk = Ys + kT * kLdP;                                // kT x kLdN
  bf16* Xk = Bk + kT * kLdN;                                // kT x kLdP
  bf16* Shi = Xk + kT * kLdP;                               // 16 kPD x kLdN
  bf16* Slo = Shi + 16 * kPD * kLdN;

  const Cell k = cell(S, H, L);
  const int nqt = gridDim.z;
  const int qt = nqt - 1 - blockIdx.z;
  const int t0 = qt * kT;
  const int nq = min(kT, L - t0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, tq = lane % 4;
  const int64_t cell_state = (k.bh * (S / L) + k.c) * P * N;

  for (int t = tid; t < L; t += blockDim.x) Ac[t] = acum[k.bh * S + k.c0 + t];
  const int64_t q0 = k.row_b + static_cast<int64_t>(k.c0 + t0) * H;
  load_tc_tile(Cs, kLdN, Cm + q0 * N, static_cast<int64_t>(H) * N, nq, N,
               16 * kND);
  load_tc_tile(Ys, kLdP, dy + q0 * P, static_cast<int64_t>(H) * P, nq, P,
               16 * kPD);
  load_split_state(Shi, Slo, kLdN, states + cell_state, P, N, 16 * kPD,
                   16 * kND);
  // on the tile of row L - 1: exp(a_L) <R_{c+1}, S_c>, from the float32
  // values, a block sum
  float end_term = 0.0f;
  if (t0 + nq == L) {
    float part = 0.0f;
    for (int e = tid; e < P * N; e += blockDim.x)
      part = fmaf(adj[cell_state + e], states[cell_state + e], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
  }
  __syncthreads();
  if (t0 + nq == L)
    end_term = expf(Ac[L - 1]) * (red[0] + red[1] + red[2] + red[3]);

  int tl[2];
  float a_t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tl[h] = 16 * warp + lane / 4 + 8 * h;
    a_t[h] = tl[h] < nq ? Ac[t0 + tl[h]] : 0.0f;
  }

  // w_t = exp(a_t) S_c^T dy_t (rows t, columns n), the start of dC; the
  // rows' C_t . w_t
  float gc[2 * kND][4];
#pragma unroll
  for (int n = 0; n < 2 * kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kPD; ++kk) {
    uint32_t a[4];
    frag_a(a, Ys, kLdP, 16 * warp, 16 * kk);
#pragma unroll
    for (int nn = 0; nn < kND; ++nn) {
      uint32_t bh[4], bl[4];
      frag_b_kn(bh, Shi, kLdN, 16 * kk, 16 * nn);
      frag_b_kn(bl, Slo, kLdN, 16 * kk, 16 * nn);
      mma_pair(gc[2 * nn], gc[2 * nn + 1], a, bh);
      mma_pair(gc[2 * nn], gc[2 * nn + 1], a, bl);
    }
  }
  float row[2] = {0.0f, 0.0f};
  {
    const float e_t[2] = {tl[0] < nq ? expf(a_t[0]) : 0.0f,
                          tl[1] < nq ? expf(a_t[1]) : 0.0f};
#pragma unroll
    for (int n = 0; n < 2 * kND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gc[n][e] *= e_t[e / 2];
        const int col = 8 * n + 2 * tq + e % 2;
        row[e / 2] = fmaf(__bfloat162float(Cs[tl[e / 2] * kLdN + col]),
                          gc[n][e], row[e / 2]);
      }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int s0 = kt * kT;
    const int nk = min(kT, L - s0);
    __syncthreads();  // S_c, or the previous key tile, is consumed
    const int64_t r0 = k.row_b + static_cast<int64_t>(k.c0 + s0) * H;
    load_tc_tile(Bk, kLdN, Bm + r0 * N, static_cast<int64_t>(H) * N, nk, N,
                 16 * kND);
    load_tc_tile(Xk, kLdP, x + r0 * P, static_cast<int64_t>(H) * P, nk, P,
                 16 * kPD);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;   // the tile's key columns c0 .. c0 + 31
      // on the diagonal tile, no key of this half precedes a row of the
      // warp's: nothing to add
      if (kt == qt && c0 > 16 * warp + 15) continue;
      float g[4][4], d[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[n][e] = d[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        uint32_t a[4], b0[4], b1[4];
        frag_a(a, Cs, kLdN, 16 * warp, 16 * kk);
        frag_b_nk(b0, Bk, kLdN, c0, 16 * kk);
        frag_b_nk(b1, Bk, kLdN, c0 + 16, 16 * kk);
        mma_pair(g[0], g[1], a, b0);
        mma_pair(g[2], g[3], a, b1);
      }
#pragma unroll
      for (int kk = 0; kk < kPD; ++kk) {
        uint32_t a[4], b0[4], b1[4];
        frag_a(a, Ys, kLdP, 16 * warp, 16 * kk);
        frag_b_nk(b0, Xk, kLdP, c0, 16 * kk);
        frag_b_nk(b1, Xk, kLdP, c0 + 16, 16 * kk);
        mma_pair(d[0], d[1], a, b0);
        mma_pair(d[2], d[3], a, b1);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sc = c0 + 8 * n + 2 * tq + e % 2;
          const int tr = tl[e / 2];
          const bool seen = tr < nq && sc < nk && t0 + tr >= s0 + sc;
          const float w = seen ? expf(a_t[e / 2] - Ac[s0 + sc]) : 0.0f;
          d[n][e] *= w;
          row[e / 2] = fmaf(g[n][e], d[n][e], row[e / 2]);
        }
      // dC += (W D) B, 16 keys a step
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t hi[4], lo[4];
        acc_to_a(hi, lo, d[2 * j], d[2 * j + 1]);
#pragma unroll
        for (int nn = 0; nn < kND; ++nn) {
          uint32_t b[4];
          frag_b_kn(b, Bk, kLdN, c0 + 16 * j, 16 * nn);
          mma_pair(gc[2 * nn], gc[2 * nn + 1], hi, b);
          mma_pair(gc[2 * nn], gc[2 * nn + 1], lo, b);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = sum4(row[h]);
    if (tq == 0 && tl[h] < nq)
      drow[k.bh * S + k.c0 + t0 + tl[h]] =
          t0 + tl[h] == L - 1 ? v + end_term : v;
  }
  store_tc_rows<kND>(dC + q0 * N, static_cast<int64_t>(H) * N, nq, N, gc);
}

// ------------------------------------------------------------------------
// pass 5: per (b, h, chunk), da = drow - dcol - q (+ sum q at the last
// row) and its reverse cumulative sum into ddtA
// ------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dtA_kernel(float* __restrict__ ddtA,
                       const float* __restrict__ drow,
                       const float* __restrict__ dcol,
                       const float* __restrict__ qrow, int S, int H,
                       int L) {
  __shared__ float rev[kMaxSsdChunk];   // da in reverse row order
  const Cell k = cell(S, H, L);
  const int tid = threadIdx.x;
  const int64_t base = k.bh * S + k.c0;
  for (int t = tid; t < L; t += kThreads)
    rev[L - 1 - t] = drow[base + t] - dcol[base + t] - qrow[base + t];
  __syncthreads();
  if (tid < 32) {
    // sum of q, then the inclusive scan of rev: a run of rows a lane and
    // a shuffle scan of the lane totals
    float qsum = 0.0f;
    for (int t = tid; t < L; t += 32) qsum += qrow[base + t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      qsum += __shfl_xor_sync(0xffffffffu, qsum, off);
    const int per = (L + 31) / 32;
    const int lo = tid * per;
    float run = 0.0f;
    for (int i = 0; i < per && lo + i < L; ++i) {
      run += rev[lo + i];
      rev[lo + i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    for (int i = 0; i < per && lo + i < L; ++i)
      rev[lo + i] += incl - run + qsum;
  }
  __syncthreads();
  float* out = ddtA + k.row_b + static_cast<int64_t>(k.c0) * H;
  for (int t = tid; t < L; t += kThreads)
    out[t * static_cast<int64_t>(H)] = rev[L - 1 - t];
}

// ------------------------------------------------------------------------
// launcher
// ------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int kPG, int kNG>
cudaError_t launch(void* dx, float* ddtA, void* dB, void* dC, float* dinit,
                   const void* x, const float* dtA, const void* Bm,
                   const void* Cm, const float* states, const void* dy,
                   const float* dfinal, float* acum, float* adj,
                   float* drow, float* dcol, float* qrow, int64_t B,
                   int64_t S, int64_t H, int64_t P, int64_t N, int64_t L,
                   cudaStream_t stream) {
  constexpr int kLdP = ld_of(kPG), kLdN = ld_of(kNG);
  // the state (64 kPG rows) fits where a partner tile's two parts go
  static_assert(64 * kPG * kLdN <= kT * (kLdN + kLdP), "state tile");
  const int Si = static_cast<int>(S), Hi = static_cast<int>(H),
            Pi = static_cast<int>(P), Ni = static_cast<int>(N),
            Li = static_cast<int>(L);
  const dim3 cells(static_cast<unsigned>(S / L * H),
                   static_cast<unsigned>(B));
  const unsigned tiles = static_cast<unsigned>((L + kT - 1) / kT);
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);

  const size_t local_smem =
      sizeof(float) * (2 * kMaxSsdChunk + kT * (kLdP + kLdN));
  auto local = ssd_bwd_local_kernel<T, kPG, kNG>;
  cudaError_t err = cudaFuncSetAttribute(
      local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(local_smem));
  if (err != cudaSuccess) return err;
  local<<<cells, kThreads, local_smem, stream>>>(adj, acum, dyt, Ct, dtA, Si,
                                                 Hi, Pi, Ni, Li);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int PN = Pi * Ni;
  ssd_bwd_state_pass_kernel<<<dim3(static_cast<unsigned>(B * H),
                                   (PN + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(dinit, adj, acum,
                                                     dfinal, Si, Li, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(cells.x, cells.y, tiles);
  const bool tc = sizeof(T) == 2 && P % 8 == 0 && N % 8 == 0 &&
                  aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                  aligned16(dy) && aligned16(states);
  if (tc) {
    // kPD, kND = 4 kPG, 4 kNG: P and N padded to 64 or 128
    constexpr int kPD = 4 * kPG, kND = 4 * kNG;
    constexpr int kTcLdP = tc_ld(kPD), kTcLdN = tc_ld(kND);
    using bf = __nv_bfloat16;
    const bf* xb = static_cast<const bf*>(x);
    const bf* Bb = static_cast<const bf*>(Bm);
    const bf* Cb = static_cast<const bf*>(Cm);
    const bf* dyb = static_cast<const bf*>(dy);
    const size_t smem =
        sizeof(float) * (kMaxSsdChunk + 4) +
        sizeof(bf) * (2 * kT * (kTcLdP + kTcLdN) + 2 * 16 * kPD * kTcLdN);
    auto key = ssd_bwd_key_tc_kernel<kPD, kND>;
    err = cudaFuncSetAttribute(key,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    key<<<grid, kTcThreads, smem, stream>>>(
        static_cast<bf*>(dx), static_cast<bf*>(dB), dcol, qrow, xb, Bb, Cb,
        dyb, acum, adj, Si, Hi, Pi, Ni, Li);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto query = ssd_bwd_query_tc_kernel<kPD, kND>;
    err = cudaFuncSetAttribute(query,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    query<<<grid, kTcThreads, smem, stream>>>(
        static_cast<bf*>(dC), drow, xb, Bb, Cb, dyb, acum, states, adj, Si,
        Hi, Pi, Ni, Li);
  } else {
    const size_t tile_smem =
        sizeof(float) * (kMaxSsdChunk + 2 * kT * (kLdP + kLdN) +
                         2 * kT * kLdM);
    auto key = ssd_bwd_key_kernel<T, kPG, kNG>;
    err = cudaFuncSetAttribute(key,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tile_smem));
    if (err != cudaSuccess) return err;
    key<<<grid, kThreads, tile_smem, stream>>>(
        static_cast<T*>(dx), static_cast<T*>(dB), dcol, qrow, xt, Bt, Ct,
        dyt, acum, adj, Si, Hi, Pi, Ni, Li);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t query_smem =
        sizeof(float) * (kMaxSsdChunk + 2 * kT * (kLdP + kLdN) + kT * kLdM +
                         kThreads / 32);
    auto query = ssd_bwd_query_kernel<T, kPG, kNG>;
    err = cudaFuncSetAttribute(query,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(query_smem));
    if (err != cudaSuccess) return err;
    query<<<grid, kThreads, query_smem, stream>>>(
        static_cast<T*>(dC), drow, xt, Bt, Ct, dyt, acum, states, adj, Si,
        Hi, Pi, Ni, Li);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ssd_bwd_dtA_kernel<<<cells, kThreads, 0, stream>>>(ddtA, drow, dcol, qrow,
                                                     Si, Hi, Li);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_ssd_scan_bwd(void* dx, float* ddtA, void* dB, void* dC,
                                float* dinitial, const void* x,
                                const float* dtA, const void* B_,
                                const void* C_, const float* states,
                                const void* dy, const float* dfinal,
                                float* acum, float* adj, float* drow,
                                float* dcol, float* qrow, int64_t B,
                                int64_t S, int64_t H, int64_t P, int64_t N,
                                int64_t L, bool bf16, cudaStream_t stream) {
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
#define REPRO_SSD_BWD(T, PG, NG)                                            \
  return launch<T, PG, NG>(dx, ddtA, dB, dC, dinitial, x, dtA, B_, C_,      \
                           states, dy, dfinal, acum, adj, drow, dcol, qrow, \
                           B, S, H, P, N, L, stream)
  if (bf16) {
    if (P <= 64 && N <= 64) REPRO_SSD_BWD(__nv_bfloat16, 1, 1);
    if (P <= 64) REPRO_SSD_BWD(__nv_bfloat16, 1, 2);
    if (N <= 64) REPRO_SSD_BWD(__nv_bfloat16, 2, 1);
    REPRO_SSD_BWD(__nv_bfloat16, 2, 2);
  }
  if (P <= 64 && N <= 64) REPRO_SSD_BWD(float, 1, 1);
  if (P <= 64) REPRO_SSD_BWD(float, 1, 2);
  if (N <= 64) REPRO_SSD_BWD(float, 2, 1);
  REPRO_SSD_BWD(float, 2, 2);
#undef REPRO_SSD_BWD
}
