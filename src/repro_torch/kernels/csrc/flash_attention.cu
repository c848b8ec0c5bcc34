// Flash (online-softmax) GQA attention for Hopper (sm_90a), float32 math.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel). There a (batch, head, q block) cell walks the k blocks
// in grid order and carries its softmax state in VMEM scratch. Here one
// block of 256 threads owns one (b, h, 64-query tile) and loops over the
// 64-key tiles itself; blocks run independently. Each tile of K and V is
// converted to float32 into shared memory once and read by every query
// row of the block; the query heads of a group (h / (H / KV)) read the
// same KV head, and repeated KV is never materialised.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i and
// keys tx + 16 j (i, j < 4) of the 64 x 64 score tile, and the output
// columns tx + 16 c. A row's max and sum are reduced over the 16 lanes of
// its half-warp with shuffles; the probabilities go through shared memory
// to the P @ V product. Everything is float32 as in the TPU kernel, which
// upcasts q, k and v: P is not rounded to bf16 for a tensor-core product.
// The mask is the reference's: finite -1e30 scores and p = 0 where a key
// is masked, so a row whose keys are all masked (in a tile, or at all)
// gives no NaN; the normaliser has a 1e-30 floor. Key tiles that no row
// of the block can see (after the causal diagonal, before the window) are
// skipped; that changes no result, since a fully masked tile leaves the
// running state as it is.
//
// What bounds it: operations. At the prefill shape (B 8, 1024 tokens, 14
// heads of 64, causal) the product needs ~15 GFLOP, 0.23 ms at the H100's
// float32 rate outside the tensor cores (15 us at the bf16 tensor rate);
// the bytes are ~30 MB. This SIMT version does not use wgmma or TMA;
// moving it onto the tensor cores is later work.

#include <algorithm>

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * dp + static_cast<size_t>(kBK) * dp +
          static_cast<size_t>(kBK) * d + static_cast<size_t>(kBQ) * (kBK + 1));
}

// kND = output columns per thread: d <= 16 * kND.
template <typename T, int kND>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(T* __restrict__ out, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v, int Sq,
                 int Sk, int H, int KV, int d, float scale, bool causal,
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
        s < Sq ? to_f32(q[((static_cast<int64_t>(b) * Sq + s) * H + h) * d +
                          i])
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
  if (causal) k_hi = min(k_hi, q_offset + q_last + 1);
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
      Ks[r * dp + i] = s < Sk ? to_f32(k[src]) : 0.0f;
      Vs[r * d + i] = s < Sk ? to_f32(v[src]) : 0.0f;
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
        if (causal) ok[j] = ok[j] && qpos >= kpos;
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
    T* orow = out + ((static_cast<int64_t>(b) * Sq + s) * H + h) * d;
#pragma unroll
    for (int c = 0; c < kND; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int kND>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                   int64_t d, float scale, bool causal, bool has_window,
                   int64_t window, cudaStream_t stream) {
  const size_t smem = smem_bytes(static_cast<int>(d));
  auto kernel = flash_kernel<T, kND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  // query-key distances lie in [-(Sq + Sk), Sk]: clamping the window to
  // that range changes no mask and keeps it an int
  const int64_t w = std::clamp<int64_t>(window, -(Sq + Sk), Sq + Sk + 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d), scale, causal, has_window,
      static_cast<int>(w));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* out, const void* q, const void* k, const void* v,
                     int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                     int64_t KV, int64_t d, float scale, bool causal,
                     bool has_window, int64_t window, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 1>(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal,
                        has_window, window, stream);
  if (d <= 32)
    return launch<T, 2>(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal,
                        has_window, window, stream);
  if (d <= 64)
    return launch<T, 4>(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal,
                        has_window, window, stream);
  return launch<T, 8>(out, q, k, v, B, Sq, Sk, H, KV, d, scale, causal,
                      has_window, window, stream);
}

}  // namespace

cudaError_t launch_flash_attention(void* out, const void* q, const void* k,
                                   const void* v, int64_t B, int64_t Sq,
                                   int64_t Sk, int64_t H, int64_t KV,
                                   int64_t d, float scale, bool causal,
                                   bool has_window, int64_t window, bool bf16,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || H == 0) return cudaSuccess;
  return bf16 ? dispatch<__nv_bfloat16>(out, q, k, v, B, Sq, Sk, H, KV, d,
                                        scale, causal, has_window, window,
                                        stream)
              : dispatch<float>(out, q, k, v, B, Sq, Sk, H, KV, d, scale,
                                causal, has_window, window, stream);
}
