// Flash-decode for Hopper (sm_90a): one query token per (b, h) against a
// KV cache, slots [0, min(*valid_len, S)) attending, GQA, float32 math.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention (_decode_kernel). There a (batch, head) cell streams the
// cache through VMEM in grid order, one head at a time. Here:
//   * one block owns one (b, kv head) and a split of kDecodeSplit cache
//     slots, so the G = H / KV query heads of a group share every K and V
//     read (the TPU kernel reads the group's cache G times), and the
//     splits spread a long cache over the SMs (split-K);
//   * the block stages 64-slot tiles of K and V in shared memory as
//     float32, scores the G heads against them, and keeps each head's
//     running max, sum and output in the reference's online-softmax form;
//   * a second kernel combines the splits: out = sum_s e^(m_s - M) acc_s /
//     max(sum_s e^(m_s - M) l_s, 1e-30), which for one split is the TPU
//     kernel's acc / max(l, 1e-30).
// valid_len is an int32 the kernel reads from device memory (clamped to
// S, as the TPU wrapper does), so a decode loop never reads a tensor back
// to the host. Slots at or past it are not read at all: a split that
// starts past it writes the empty state (max -1e30, sum 0), which adds
// nothing to the combination.
//
// What bounds it: bytes. Each cache slot's K and V rows are read once: at
// B 8, KV 2, d 64, bf16 and 32,768 valid slots that is ~134 MB, ~40 us at
// 3.35 TB/s; the scores and the product are ~2 flop a byte.

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kBK = 64;        // slots per tile (two per lane of a warp)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAccPerThread = kMaxDecodeGroup * kMaxHeadDim / kThreads;

size_t split_smem_bytes(int G, int d) {
  return sizeof(float) *
         (static_cast<size_t>(G) * d + static_cast<size_t>(kBK) * (d + 1) +
          static_cast<size_t>(kBK) * d + static_cast<size_t>(G) * kBK +
          3 * static_cast<size_t>(G));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(float* __restrict__ part_acc,
                        float* __restrict__ part_ml, const T* __restrict__ q,
                        const T* __restrict__ kc, const T* __restrict__ vc,
                        const int32_t* __restrict__ valid_len, int S, int H,
                        int KV, int d, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int dp = d + 1;
  float* Qs = smem;                // G x d
  float* Ks = Qs + G * d;          // kBK x dp
  float* Vs = Ks + kBK * dp;       // kBK x d
  float* Ps = Vs + kBK * d;        // G x kBK
  float* Ms = Ps + G * kBK;        // G running max
  float* Ls = Ms + G;              // G running sum
  float* As = Ls + G;              // G rescale of this tile

  const int vl = min(*valid_len, S);
  const int s0 = split * static_cast<int>(kDecodeSplit);
  const int s1 = min(s0 + static_cast<int>(kDecodeSplit), vl);

  for (int e = tid; e < G * d; e += kThreads)
    Qs[e] = to_f32(q[(static_cast<int64_t>(b) * H + kvh * G) * d + e]);
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.0f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.0f;

  for (int k0 = s0; k0 < s1; k0 += kBK) {
    const int n = min(kBK, s1 - k0);
    __syncthreads();  // Qs written; the previous tile consumed
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d;
      const int i = e - r * d;
      const int64_t src =
          ((static_cast<int64_t>(b) * S + k0 + r) * KV + kvh) * d + i;
      Ks[r * dp + i] = r < n ? to_f32(kc[src]) : 0.0f;
      Vs[r * d + i] = r < n ? to_f32(vc[src]) : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < G * kBK; e += kThreads) {
      const int g = e / kBK;
      const int c = e - g * kBK;
      float s = 0.0f;
      for (int i = 0; i < d; ++i) s += Qs[g * d + i] * Ks[c * dp + i];
      Ps[e] = c < n ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      const float a = Ps[g * kBK + lane];
      const float c = Ps[g * kBK + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = lane < n ? expf(a - m_new) : 0.0f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.0f;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[g * kBK + lane] = pa;
      Ps[g * kBK + lane + 32] = pc;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < G * d) {
        const int g = e / d;
        const int col = e - g * d;
        float a = acc[j] * As[g];
        for (int c = 0; c < n; ++c) a += Ps[g * kBK + c] * Vs[c * d + col];
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // Ms, Ls final (also when this split saw no slot)

  const int64_t part = (static_cast<int64_t>(b) * KV + kvh) * nsplit + split;
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * d) part_acc[part * G * d + e] = acc[j];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(part * G + g) * 2] = Ms[g];
    part_ml[(part * G + g) * 2 + 1] = Ls[g];
  }
}

// One block per (h, b), one thread per output column.
template <typename T>
__global__ void decode_combine_kernel(T* __restrict__ out,
                                      const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      int nsplit, int H, int KV, int d) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int col = threadIdx.x;
  if (col >= d) return;
  const int G = H / KV;
  const int kvh = h / G;
  const int g = h - kvh * G;
  const int64_t base = (static_cast<int64_t>(b) * KV + kvh) * nsplit;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[((base + s) * G + g) * 2]);
  float num = 0.0f;
  float den = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_ml[((base + s) * G + g) * 2] - mx);
    den += w * part_ml[((base + s) * G + g) * 2 + 1];
    num += w * part_acc[((base + s) * G + g) * d + col];
  }
  out[(static_cast<int64_t>(b) * H + h) * d + col] =
      from_f32<T>(num / fmaxf(den, 1e-30f));
}

template <typename T>
cudaError_t launch(void* out, const void* q, const void* k_cache,
                   const void* v_cache, const int32_t* valid_len,
                   float* part_acc, float* part_ml, int64_t B, int64_t S,
                   int64_t H, int64_t KV, int64_t d, float scale,
                   cudaStream_t stream) {
  const int G = static_cast<int>(H / KV);
  const size_t smem = split_smem_bytes(G, static_cast<int>(d));
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t nsplit = (S + kDecodeSplit - 1) / kDecodeSplit;
  const dim3 grid(static_cast<unsigned>(nsplit), static_cast<unsigned>(KV),
                  static_cast<unsigned>(B));
  decode_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      part_acc, part_ml, static_cast<const T*>(q),
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      valid_len, static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = static_cast<int>((d + 31) / 32 * 32);
  decode_combine_kernel<T><<<dim3(static_cast<unsigned>(H),
                                  static_cast<unsigned>(B)),
                             threads, 0, stream>>>(
      static_cast<T*>(out), part_acc, part_ml, static_cast<int>(nsplit),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(d));
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_decode_attention(void* out, const void* q,
                                    const void* k_cache, const void* v_cache,
                                    const int32_t* valid_len, float* part_acc,
                                    float* part_ml, int64_t B, int64_t S,
                                    int64_t H, int64_t KV, int64_t d,
                                    float scale, bool bf16,
                                    cudaStream_t stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  return bf16 ? launch<__nv_bfloat16>(out, q, k_cache, v_cache, valid_len,
                                      part_acc, part_ml, B, S, H, KV, d,
                                      scale, stream)
              : launch<float>(out, q, k_cache, v_cache, valid_len, part_acc,
                              part_ml, B, S, H, KV, d, scale, stream);
}
