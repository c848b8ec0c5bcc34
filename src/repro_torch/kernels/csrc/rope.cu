// Rotary position embedding (RoPE) for Hopper (sm_90a), forward and
// backward, in the half-split layout. For a row x of q (B, Sq, H, d) or k
// (B, Sk, KV, d) at position p, with x1 = x[:d/2], x2 = x[d/2:] and the
// angles a_i = p f_i, f_i = 1 / theta^(i / (d/2)):
//   out1 = x1 cos a - x2 sin a,   out2 = x1 sin a + x2 cos a,
// in float32, rounded once to the input's type. The backward is the same
// pass with sin a negated: the inverse rotation, which is the forward's
// transpose.
//
// Replaces no TPU kernel: the JAX package rotates in jnp
// (repro/models/layers.py:apply_rope), which XLA fuses into the
// projections around it. PyTorch runs the same formula eagerly as about a
// dozen float32 passes over q and k (the casts, four half-width products,
// the sum, the difference, the cat, the cast back; autograd's backward as
// many again), ~48 bytes an element where one pass moves 4 (bf16 read once
// and written once). Bound by bytes: at smollm-360m's training shape (32 x
// 1024 tokens, 15 + 5 heads of 64) a call moves 168 MB, ~50 us at 3.35
// TB/s.
//
// Design: one thread takes one 16-byte vector of the first half of a row
// and the matching vector of its second half, for every head of one token:
// the frequencies, angles, cosines and sines are computed once a (token,
// vector) and used for all H query heads and KV key heads (k's when its
// position differs from q's). Neighbouring threads read neighbouring
// vectors; a thread has four heads' loads in flight before it computes.
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: no FMA contraction), and the frequencies, cosines
// and sines are the float operations PyTorch's CUDA kernels run for the
// plain version (i * (1 / (d/2)), powf(theta, .), its reciprocal, p f,
// cosf, sinf; no fast-math), so the kernel gives the plain version's bits
// on the card.

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kThreads = 128;
constexpr int kHeadsInFlight = 4;  // heads a thread loads before computing

// 16 bytes of T: kVec values.
template <typename T>
struct Vec {
  static constexpr int kVec = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* in, float) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}

__device__ __forceinline__ uint4 pack(const float* in, __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // round to nearest even, each value alone
    pairs[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  return v;
}

// cos and sin (negated for the inverse rotation) of p f_i for the kVec
// frequencies of one vector.
template <int kVec>
__device__ __forceinline__ void angles(float p, const float* f, bool inverse,
                                       float* c, float* s) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float a = __fmul_rn(p, f[e]);
    c[e] = cosf(a);
    const float sa = sinf(a);
    s[e] = inverse ? -sa : sa;
  }
}

// Rotates one vector of each of `heads` rows of width d, from `x` to `out`
// (both at the token's first row, offset by the thread's vector).
template <typename T>
__device__ __forceinline__ void rotate_rows(T* __restrict__ out,
                                            const T* __restrict__ x,
                                            int heads, int d, int half,
                                            const float* c, const float* s) {
  constexpr int kVec = Vec<T>::kVec;
  for (int h0 = 0; h0 < heads; h0 += kHeadsInFlight) {
    uint4 lo[kHeadsInFlight], hi[kHeadsInFlight];
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (h0 + u < heads) {
        const T* row = x + static_cast<int64_t>(h0 + u) * d;
        lo[u] = *reinterpret_cast<const uint4*>(row);
        hi[u] = *reinterpret_cast<const uint4*>(row + half);
      }
    }
#pragma unroll
    for (int u = 0; u < kHeadsInFlight; ++u) {
      if (h0 + u < heads) {
        float x1[kVec], x2[kVec], o1[kVec], o2[kVec];
        unpack(lo[u], x1, T());
        unpack(hi[u], x2, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          o1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], s[e]));
          o2[e] = __fadd_rn(__fmul_rn(x1[e], s[e]), __fmul_rn(x2[e], c[e]));
        }
        T* row = out + static_cast<int64_t>(h0 + u) * d;
        *reinterpret_cast<uint4*>(row) = pack(o1, T());
        *reinterpret_cast<uint4*>(row + half) = pack(o2, T());
      }
    }
  }
}

// One thread a (b, s, vector) of the S = max(Sq, Sk) tokens: q's H rows of
// token s when s < Sq, k's KV rows when k is given and s < Sk.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(T* __restrict__ qo, T* __restrict__ ko,
                const T* __restrict__ q, const T* __restrict__ k,
                const P* __restrict__ pos_q, const P* __restrict__ pos_k,
                int64_t B, int64_t S, int64_t Sq, int64_t Sk, int H, int KV,
                int d, float theta, bool inverse) {
  constexpr int kVec = Vec<T>::kVec;
  const int half = d / 2;
  const int vecs = half / kVec;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= B * S * vecs) return;
  const int j = static_cast<int>(t % vecs);
  const int64_t bs = t / vecs;
  const int64_t s = bs % S, b = bs / S;
  const int i0 = j * kVec;

  // f_i = 1 / theta^(i * (1 / half)), as torch's 1.0 / (theta **
  // (arange(half) / half)) on the card: the division by a scalar is a
  // product with its reciprocal, pow is powf, the reciprocal exact
  const float step = __fdiv_rn(1.0f, static_cast<float>(half));
  float f[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    f[e] = __fdiv_rn(
        1.0f, powf(theta, __fmul_rn(static_cast<float>(i0 + e), step)));

  float c[kVec], sn[kVec];
  bool have = false;
  P p_have = 0;
  if (s < Sq) {
    p_have = pos_q[s];
    angles<kVec>(static_cast<float>(p_have), f, inverse, c, sn);
    have = true;
    const int64_t row = (b * Sq + s) * H;
    rotate_rows(qo + row * d + i0, q + row * d + i0, H, d, half, c, sn);
  }
  if (k != nullptr && s < Sk) {
    const P p = pos_k[s];
    if (!have || p != p_have)
      angles<kVec>(static_cast<float>(p), f, inverse, c, sn);
    const int64_t row = (b * Sk + s) * KV;
    rotate_rows(ko + row * d + i0, k + row * d + i0, KV, d, half, c, sn);
  }
}

template <typename T, typename P>
cudaError_t launch(void* qo, void* ko, const void* q, const void* k,
                   const void* pos_q, const void* pos_k, int64_t B,
                   int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t d,
                   float theta, bool inverse, cudaStream_t stream) {
  const int64_t S = Sq > Sk ? Sq : Sk;
  const int64_t threads = B * S * (d / 2 / Vec<T>::kVec);
  if (threads == 0) return cudaSuccess;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rope_kernel<T, P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(qo), static_cast<T*>(ko), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const P*>(pos_q),
      static_cast<const P*>(pos_k), B, S, Sq, Sk, static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d), theta, inverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_positions(void* qo, void* ko, const void* q,
                             const void* k, const void* pos_q,
                             const void* pos_k, bool pos64, int64_t B,
                             int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                             int64_t d, float theta, bool inverse,
                             cudaStream_t stream) {
  return pos64 ? launch<T, int64_t>(qo, ko, q, k, pos_q, pos_k, B, Sq, Sk, H,
                                    KV, d, theta, inverse, stream)
               : launch<T, int32_t>(qo, ko, q, k, pos_q, pos_k, B, Sq, Sk, H,
                                    KV, d, theta, inverse, stream);
}

}  // namespace

cudaError_t launch_rope(void* qo, void* ko, const void* q, const void* k,
                        const void* pos_q, const void* pos_k, bool pos64,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                        int64_t KV, int64_t d, float theta, bool inverse,
                        bool bf16, cudaStream_t stream) {
  return bf16 ? launch_positions<__nv_bfloat16>(qo, ko, q, k, pos_q, pos_k,
                                                pos64, B, Sq, Sk, H, KV, d,
                                                theta, inverse, stream)
              : launch_positions<float>(qo, ko, q, k, pos_q, pos_k, pos64, B,
                                        Sq, Sk, H, KV, d, theta, inverse,
                                        stream);
}
