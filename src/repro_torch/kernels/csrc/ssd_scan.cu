// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 math.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan (_ssd_kernel).
// There the grid is (batch, head, chunk) with the chunk axis sequential
// ("arbitrary"): the (P, N) state sits in VMEM scratch and is carried from
// one grid step to the next, and each step holds its whole L x L chunk in
// VMEM. Hopper runs blocks in no order and gives a block at most 227 KB,
// so neither carries over. Here one block of 256 threads owns one (b, h)
// and walks its chunks itself; the float32 state (P x N, 32 KB at P 64,
// N 128) stays in shared memory for the whole walk. Within a chunk the
// L x L work is tiled: 64-row query tiles against 64-row key tiles, and
// key tiles after the diagonal are skipped (their decay weights are 0).
//
// Per chunk, with A_cum = cumsum(dtA) over the chunk:
//   y[t]  = sum_{s <= t} (C[t] . B[s]) exp(A_cum[t] - A_cum[s]) x[s]
//           + exp(A_cum[t]) (C[t] . state)
//   state = exp(A_cum[L-1]) state
//           + sum_s x[s] (B[s] exp(A_cum[L-1] - A_cum[s]))
// Every y tile reads the state from before the chunk; the state is updated
// only after the chunk's last y tile (a barrier sits between the two).
//
// Thread (ty, tx) = (tid / 16, tid % 16). In a y tile it owns rows
// ty + 16 i (i < 4) and columns tx + 16 c of y; in a score tile, rows
// ty + 16 i and keys tx + 16 j; in the state update, state rows
// p = ty + 16 i and columns n = tx + 16 j, accumulated in registers over
// the chunk's rows and written back once. Shared rows of N are padded to
// N + 1 floats, so the 16 rows a half-warp reads at one column fall in 16
// banks. The cumulative sum is one warp's scan (8 rows a lane, then a
// shuffle scan of the lane totals).
//
// What bounds it: bytes. At the serving shapes (B 8, S 1024, bf16, L 256)
// mamba2-130m (H 24, P 64, N 128) moves 154.9 MB (0.046 ms at 3.35 TB/s)
// for 25.8 GFLOP of the reference's L x L products (0.026 ms at the bf16
// tensor rate); zamba2-1.2b (H 64, P 64, N 64) 274.7 MB (0.082 ms) for
// 42.9 GFLOP. B and C arrive broadcast to every head (the reference's
// interface), so the bytes count H copies of them. This version runs the
// products on the float32 SIMT units (67 TFLOP/s) without wgmma or TMA,
// rereads each key tile from L2 once per query tile at or below it, and
// runs one block per (b, h): 192 blocks (mamba2) or 512 (zamba2) on 132
// SMs, with 133 KB (mamba2) or 83 KB (zamba2) of shared memory a block,
// so one or two blocks an SM. Each of those is later work.

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kT = 64;  // rows of a query tile and of a key tile
constexpr int kThreads = 256;

size_t smem_floats(int P, int N) {
  const size_t np = static_cast<size_t>(N) + 1;
  return static_cast<size_t>(P) * np       // state
         + 2 * static_cast<size_t>(kT) * np  // C tile, B tile
         + static_cast<size_t>(kT) * P       // x tile
         + static_cast<size_t>(kT) * (kT + 1)  // masked scores
         + kMaxSsdChunk;                     // A_cum of the chunk
}

// n rows of W elements, as float32, into a kT-row shared tile with row
// stride `ld`; rows past n are zero. Row r starts at element
// (row0 + r * row_stride) * W of src. Each row is scaled by scale[r] when
// `scale` is given.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t row0, int64_t row_stride,
                                          int n, int W,
                                          const float* scale) {
  for (int e = threadIdx.x; e < kT * W; e += kThreads) {
    const int r = e / W;
    const int j = e - r * W;
    float v = 0.0f;
    if (r < n) {
      v = to_f32(src[(row0 + r * row_stride) * W + j]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld + j] = v;
  }
}

// kPC = columns of P a thread owns in 16s (P <= 16 kPC); kNC likewise for N.
template <typename T, int kPC, int kNC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(T* __restrict__ y, T* __restrict__ fin,
                    const T* __restrict__ x, const float* __restrict__ dtA,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int np = N + 1;
  float* st = smem;                 // P x np: the carried state
  float* Cs = st + P * np;          // kT x np: C rows of the query tile
  float* Bs = Cs + kT * np;         // kT x np: B rows of a key tile
  float* Xs = Bs + kT * np;         // kT x P: x rows of a key tile
  float* Ps = Xs + kT * P;          // kT x (kT + 1): masked scores
  float* Ac = Ps + kT * (kT + 1);   // L: A_cum of the chunk

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // row s of a (B, S, H, W) tensor starts at (row(s)) * W, row(s) = the
  // flat (b, s, h) index; consecutive s are H rows apart
  const int64_t row_b = static_cast<int64_t>(b) * S * H + h;

  for (int e = tid; e < P * np; e += kThreads) st[e] = 0.0f;

  const int tiles = (L + kT - 1) / kT;
  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's Ac, Bs and Xs are consumed
    for (int t = tid; t < L; t += kThreads)
      Ac[t] = dtA[row_b + static_cast<int64_t>(c0 + t) * H];
    __syncthreads();
    if (tid < 32) {  // inclusive cumulative sum over the chunk
      const int per = (L + 31) / 32;
      const int lo = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per && lo + k < L; ++k) {
        run += Ac[lo + k];
        Ac[lo + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float base = incl - run;
      for (int k = 0; k < per && lo + k < L; ++k) Ac[lo + k] += base;
    }
    __syncthreads();

    // y, one query tile at a time, from the state before this chunk
    for (int qt = 0; qt < tiles; ++qt) {
      const int t0 = qt * kT;
      const int nq = min(kT, L - t0);
      __syncthreads();  // the previous tile's Cs is consumed
      load_tile(Cs, np, Cm, row_b + static_cast<int64_t>(c0 + t0) * H, H, nq,
                N, nullptr);
      __syncthreads();

      float acc[4][kPC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[i][c] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * np + n];
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? st[p * np + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kPC; ++c) acc[i][c] += cv[i] * sv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float decay = t < nq ? expf(Ac[t0 + t]) : 0.0f;
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[i][c] *= decay;
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int s0 = kt * kT;
        const int nk = min(kT, L - s0);
        __syncthreads();  // the previous key tile's Bs, Xs, Ps are consumed
        const int64_t r0 = row_b + static_cast<int64_t>(c0 + s0) * H;
        load_tile(Bs, np, Bm, r0, H, nk, N,
                  nullptr);
        load_tile(Xs, P, x, r0, H, nk, P, nullptr);
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * np + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * np + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;  // chunk rows
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            Ps[(ty + 16 * i) * (kT + 1) + tx + 16 * j] =
                (s <= t && t < L) ? g[i][j] * expf(Ac[t] - Ac[s]) : 0.0f;
          }
        }
        __syncthreads();

        for (int s = 0; s < nk; ++s) {
          float pv[4], xv[kPC];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kT + 1) + s];
#pragma unroll
          for (int c = 0; c < kPC; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < P ? Xs[s * P + p] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < kPC; ++c) acc[i][c] += pv[i] * xv[c];
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nq) continue;
        T* yrow = y + (row_b + static_cast<int64_t>(c0 + t0 + t) * H) * P;
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yrow[p] = from_f32<T>(acc[i][c]);
        }
      }
    }

    // the state update, after every y tile of the chunk has read the state
    const float a_last = Ac[L - 1];
    const float carry = expf(a_last);
    float sacc[kPC][kNC];
#pragma unroll
    for (int i = 0; i < kPC; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int n = tx + 16 * j;
        sacc[i][j] = (p < P && n < N) ? carry * st[p * np + n] : 0.0f;
      }
    }
    for (int kt = 0; kt < tiles; ++kt) {
      const int s0 = kt * kT;
      const int nk = min(kT, L - s0);
      __syncthreads();  // Bs, Xs (and Ps) of the y tiles are consumed
      // the decays exp(A_cum[L-1] - A_cum[s]) of the tile, into Ps' first row
      for (int s = tid; s < nk; s += kThreads)
        Ps[s] = expf(a_last - Ac[s0 + s]);
      __syncthreads();
      const int64_t r0 = row_b + static_cast<int64_t>(c0 + s0) * H;
      load_tile(Bs, np, Bm, r0, H, nk, N, Ps);
      load_tile(Xs, P, x, r0, H, nk, P, nullptr);
      __syncthreads();
      for (int s = 0; s < nk; ++s) {
        float xv[kPC], bv[kNC];
#pragma unroll
        for (int i = 0; i < kPC; ++i) {
          const int p = ty + 16 * i;
          xv[i] = p < P ? Xs[s * P + p] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = tx + 16 * j;
          bv[j] = n < N ? Bs[s * np + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kPC; ++i)
#pragma unroll
          for (int j = 0; j < kNC; ++j) sacc[i][j] += xv[i] * bv[j];
      }
    }
    // each thread rewrites only the state entries it alone reads above
#pragma unroll
    for (int i = 0; i < kPC; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) st[p * np + n] = sacc[i][j];
      }
    }
    if (c0 + L == S) {
      T* frow = fin + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
      for (int i = 0; i < kPC; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = tx + 16 * j;
          if (p < P && n < N) frow[p * N + n] = from_f32<T>(sacc[i][j]);
        }
      }
    }
  }
}

template <typename T, int kPC, int kNC>
cudaError_t launch(void* y, void* fin, const void* x, const float* dtA,
                   const void* Bm, const void* Cm, int64_t B, int64_t S,
                   int64_t H, int64_t P, int64_t N, int64_t L,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(static_cast<int>(P), static_cast<int>(N)) *
                      sizeof(float);
  auto kernel = ssd_scan_kernel<T, kPC, kNC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(y), static_cast<T*>(fin), static_cast<const T*>(x),
      dtA, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(N), static_cast<int>(L));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* y, void* fin, const void* x, const float* dtA,
                     const void* Bm, const void* Cm, int64_t B, int64_t S,
                     int64_t H, int64_t P, int64_t N, int64_t L,
                     cudaStream_t stream) {
  if (P <= 64 && N <= 64)
    return launch<T, 4, 4>(y, fin, x, dtA, Bm, Cm, B, S, H, P, N, L, stream);
  if (P <= 64)
    return launch<T, 4, 8>(y, fin, x, dtA, Bm, Cm, B, S, H, P, N, L, stream);
  if (N <= 64)
    return launch<T, 8, 4>(y, fin, x, dtA, Bm, Cm, B, S, H, P, N, L, stream);
  return launch<T, 8, 8>(y, fin, x, dtA, Bm, Cm, B, S, H, P, N, L, stream);
}

}  // namespace

cudaError_t launch_ssd_scan(void* y, void* final_state, const void* x,
                            const float* dtA, const void* B_, const void* C_,
                            int64_t B, int64_t S, int64_t H, int64_t P,
                            int64_t N, int64_t L, bool bf16,
                            cudaStream_t stream) {
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
  return bf16 ? dispatch<__nv_bfloat16>(y, final_state, x, dtA, B_, C_, B, S,
                                        H, P, N, L, stream)
              : dispatch<float>(y, final_state, x, dtA, B_, C_, B, S, H, P, N,
                                L, stream);
}
