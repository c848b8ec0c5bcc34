// Flash-decode for Hopper (sm_90a): one query token per (b, h) against a
// KV cache, slots [0, min(*valid_len, S)) attending, GQA, float32 math.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention (_decode_kernel). There a (batch, head) cell streams the
// cache through VMEM in grid order, one head at a time, and carries its
// softmax state in scratch. Here blocks run in parallel and in no order:
// one block owns one (b, kv head, split of the cache) and up to
// kDecodeHeadChunk query heads of the group, so the G = H / KV heads of a
// group share every K and V read (the TPU kernel reads the group's cache
// G times; a group of more than eight heads here reads it once a chunk),
// and a second kernel combines the splits.
//
// What bounds it: bytes. Each valid slot's K and V rows are read once. At
// qwen2-0.5b's decode_32k (B 8, KV 2, d 64, bf16, 32,768 slots) that is
// 134.2 MB, 0.04007 ms at 3.35 TB/s; over zamba2-1.2b's serving cache (B
// 8, KV 32, d 64, 1,088 slots) 71.3 MB, 21.3 us.
//
// Why float32 on the CUDA cores, with no tensor cores: a score and its
// share of P V cost 4 d flop a head for the 4 d bytes of a bf16 slot, so
// the work is G flop a byte (7 at qwen2's G 7, 1 at zamba2's G 1, 16 at
// the binding's limit), far below the ~295 flop a byte where Hopper's
// tensor cores start to pay. At 3.35 TB/s, G 7 needs ~23 TFLOP/s of
// float32 FMA, a third of the CUDA cores' 67. So the reference's
// arithmetic stays as it is (decode_attention.py:39-53: q, k and v upcast
// to float32, p and both products in float32), and the design moves bytes:
//   * A lane holds kLaneElems (8) consecutive elements of a key row, 16
//     bytes of bf16: kL lanes hold a row (8 up to d 64, 16 up to d 128,
//     the whole warp up to d 256), so a warp step covers 32 / kL slots.
//     The lane converts its elements to float32 once and uses them for
//     every head of the block; it keeps
//     q's matching elements in float32 registers. Its partial dot
//     products of the kH heads are summed over the row's lanes by a
//     transposed butterfly (fold_heads: at each __shfl_xor_sync a lane
//     gives away half of the heads it holds), kH - 1 + log2(kL / kH)
//     shuffles instead of kH log2(kL), and leave each lane the whole
//     score of one head.
//   * K and V reach shared memory by 16-byte cp.async in a ring of
//     kStages stages a warp, each of stage_steps steps (4 KB a warp), so
//     two stages are in flight while one computes. Each lane copies the
//     bytes it reads back itself, so its own cp.async.wait_group orders
//     them: no barrier in the loop. Nothing is converted on the way: no
//     float32 copy of K or V goes through shared memory.
//   * Each row of a warp step (a slot every kWarps * 32 / kL) keeps its
//     own running max m, sum l and output acc for every head, updated
//     once a stage in the reference's form: p = ok ? exp(s - m_new) : 0,
//     alpha = exp(m_prev - m_new), l = alpha l + sum(p), acc = alpha acc +
//     sum(p v), all float32. A lane keeps m and l of the head whose score
//     it holds and computes that head's p and alpha; the row's lanes take
//     them by __shfl_sync for their columns of acc. The exponentials are
//     2^(s c - m c) with c = scale log2(e): the scale d**-0.5 multiplies
//     the float32 score after the product, as in the reference, and m
//     lives in log2 units.
//   * At the end of its split the block merges the rows of each warp by
//     shuffles, then the warps through shared memory (the ring's bytes),
//     and writes the split's state; the combine kernel merges the splits:
//     out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30),
//     which for one split is the TPU kernel's acc / max(l, 1e-30).
//   * The splits (decode_split_len, model_ops.h) make the grid one wave
//     of the blocks the SMs hold at once (three an SM at eight heads,
//     four at one), at every shape the serving path runs.
//   * Rows that 16-byte copies cannot take (d % 8 != 0, or a cache base
//     off 16 bytes) are loaded element by element straight into registers
//     by the same kernel (kVec = false).
// valid_len is an int32 the kernel reads from device memory (clamped to
// S, as the TPU wrapper does), so a decode loop never reads a tensor back
// to the host. Slots at or past it are not read: a split that starts past
// it writes the empty state (max -1e30, sum 0), which adds nothing; the
// finite -1e30 keeps every difference of maxima finite, so no NaN.

#include "model_dtype.cuh"
#include "model_ops.h"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneElems = 8;  // consecutive elements of a row a lane holds
constexpr int kStages = 3;     // stages of a warp's ring
constexpr int kCombineThreads = 128;

// 32-bit words of a lane's elements of one row: 4 (bf16) or 8 (float32).
template <typename T>
__host__ __device__ constexpr int lane_words() {
  return kLaneElems * static_cast<int>(sizeof(T)) / 4;
}

// Steps of a stage, i.e. slots a row takes per update of its softmax
// state: 4 (bf16) or 2 (float32), a stage being 4 KB a warp either way.
template <typename T>
__host__ __device__ constexpr int stage_steps() {
  return 8 / static_cast<int>(sizeof(T));
}

// 32-bit words of a warp's ring: [stage][step][K, V][lane][lane_words].
template <typename T>
__host__ __device__ constexpr int ring_words() {
  return kStages * stage_steps<T>() * 2 * 32 * lane_words<T>();
}

// The merge's states (kWarps x heads x (d + 2) floats) fit in the rings,
// up to the largest head dimension: 8,256 of the 12,288 words at d 256.
static_assert(kWarps * kDecodeHeadChunk * (kMaxHeadDim + 2) <=
                  kWarps * ring_words<float>(),
              "decode merge area");

template <typename T>
struct SplitArgs {
  float* part_acc;
  float* part_ml;
  const T* q;
  const T* kc;
  const T* vc;
  const int32_t* valid_len;
  int S, H, KV, d;
  int split_len;  // slots of a split
  float c;        // scale * log2(e)
};

// A lane's elements as float32 from its words (element 2j in the low half
// of word j for bf16; the bf16 bits are the float's high half).
template <typename T>
__device__ __forceinline__ void unpack(const uint32_t (&w)[lane_words<T>()],
                                       float (&x)[kLaneElems]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < kLaneElems / 2; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneElems; ++j) x[j] = __uint_as_float(w[j]);
  }
}

// A lane's words of one row from its place in the ring (16-byte loads).
template <typename T>
__device__ __forceinline__ void load_shared(uint32_t (&w)[lane_words<T>()],
                                            const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < lane_words<T>() / 4; ++i) {
    const uint4 t = reinterpret_cast<const uint4*>(p)[i];
    w[4 * i] = t.x;
    w[4 * i + 1] = t.y;
    w[4 * i + 2] = t.z;
    w[4 * i + 3] = t.w;
  }
}

// The same from device memory element by element (kVec false): the n
// elements of the row left from p, zeros past them and where !ok.
template <typename T>
__device__ __forceinline__ void load_elems(uint32_t (&w)[lane_words<T>()],
                                           const T* p, int n, bool ok) {
  if constexpr (sizeof(T) == 2) {
    const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int j = 0; j < kLaneElems / 2; ++j) {
      const uint32_t lo = ok && 2 * j < n ? e[2 * j] : 0u;
      const uint32_t hi = ok && 2 * j + 1 < n ? e[2 * j + 1] : 0u;
      w[j] = lo | hi << 16;
    }
  } else {
    const uint32_t* e = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < kLaneElems; ++j) w[j] = ok && j < n ? e[j] : 0u;
  }
}

// Sums a row's partial dot products of kH heads over its lanes. While a
// lane holds kN > 1 values, the lanes kO apart swap halves: the lane with
// bit kO of its place lr set keeps the upper half and adds its partner's,
// the other the lower. One value left, it sums over the lanes still
// apart. v[0] ends as the whole dot of head lr / (kL / kH).
template <int kN, int kO, int kH>
__device__ __forceinline__ void fold_heads(float (&v)[kH], int lr) {
  if constexpr (kO > 0) {
    if constexpr (kN > 1) {
      const bool upper = lr & kO;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const float give = upper ? v[i] : v[i + kN / 2];
        const float keep = upper ? v[i + kN / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, kO);
      }
      fold_heads<kN / 2, kO / 2, kH>(v, lr);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kO);
      fold_heads<1, kO / 2, kH>(v, lr);
    }
  }
}

// One block: kH (1 or 8) heads of a group, one split of the cache; kL
// lanes a key row. grid (splits, KV x head chunks, B). The loop computes
// all kH heads without a branch (a head past the group has q = 0, and its
// output is never written): branches around each head's work would keep
// the compiler from interleaving the heads' chains of FMAs and shuffles.
// Blocks an SM: decode_blocks_per_sm (model_ops.h).
template <typename T, int kH, int kL, bool kVec>
__global__ void __launch_bounds__(kThreads, decode_blocks_per_sm(kH))
    decode_split_kernel(const SplitArgs<T> a) {
  constexpr int kU = stage_steps<T>();
  constexpr int kW = lane_words<T>();
  constexpr int kRows = 32 / kL;   // slots of a warp step
  constexpr int kReps = kL / kH;   // lanes of a row that hold one head
  __shared__ __align__(16) uint32_t smem[kWarps * ring_words<T>()];
  const int d = a.d;
  const int G = a.H / a.KV;
  const int chunks = (G + kH - 1) / kH;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y - kvh * chunks) * kH;
  const int gn = min(kH, G - g0);
  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rg = lane / kL;       // this lane's row of a warp step
  const int lr = lane % kL;       // its place in the row
  const int row0 = rg * kL;       // the row's first lane
  const int e0 = lr * kLaneElems;
  const int vl = min(*a.valid_len, a.S);
  const int s0 = split * a.split_len;
  const int s1 = min(s0 + a.split_len, vl);
  // step t of this warp covers slots first + t * per_step + [0, kRows)
  constexpr int per_step = kWarps * kRows;
  const int first = s0 + warp * kRows;
  const int steps = s1 > first ? (s1 - first + per_step - 1) / per_step : 0;
  const int stages = (steps + kU - 1) / kU;

  float qf[kH][kLaneElems];
  float acc[kH][kLaneElems];
  const T* qg = a.q + (static_cast<int64_t>(b) * a.H + kvh * G + g0) * d;
#pragma unroll
  for (int g = 0; g < kH; ++g) {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      qf[g][e] = g < gn && e0 + e < d ? to_f32(qg[g * d + e0 + e]) : 0.0f;
      acc[g][e] = 0.0f;
    }
  }
  float m_own = kNegInf;  // of head lr / kReps
  float l_own = 0.0f;

  const int64_t row = static_cast<int64_t>(a.KV) * d;  // between slots
  const int64_t base = (static_cast<int64_t>(b) * a.S * a.KV + kvh) * d + e0;
  const T* kp = a.kc + base;
  const T* vp = a.vc + base;
  uint32_t* ring = smem + warp * ring_words<T>();
  auto slot_of = [&](int t) { return first + t * per_step + rg; };
  auto at = [&](int stage, int u, int kv) {
    return ring + ((stage * kU + u) * 2 + kv) * 32 * kW + lane * kW;
  };
  // Stage j's copies, one cp.async group (empty past the last stage, so
  // that the count of pending groups stays fixed).
  auto fetch = [&](int j) {
    if (j < stages) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = slot_of(j * kU + u);
        const bool ok = s < s1 && e0 < d;
        const int64_t off = ok ? s * row : 0;
#pragma unroll
        for (int i = 0; i < kW / 4; ++i) {
          const int e = i * 16 / static_cast<int>(sizeof(T));
          cp_async_16(at(j % kStages, u, 0) + 4 * i,
                      ok ? kp + off + e : a.kc, ok);
          cp_async_16(at(j % kStages, u, 1) + 4 * i,
                      ok ? vp + off + e : a.vc, ok);
        }
      }
    }
    cp_async_commit();
  };

  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) fetch(j);
  }
  for (int j = 0; j < stages; ++j) {
    if constexpr (kVec) {
      fetch(j + kStages - 1);
      cp_async_wait<kStages - 1>();  // stage j is in
    }
    bool ok[kU];
    float p[kU];  // this lane's head: scores, then probabilities
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int slot = slot_of(j * kU + u);
      ok[u] = slot < s1;
      uint32_t w[kW];
      if constexpr (kVec) {
        load_shared<T>(w, at(j % kStages, u, 0));
      } else {
        load_elems<T>(w, kp + slot * row, d - e0, ok[u]);
      }
      float x[kLaneElems];
      unpack<T>(w, x);
      float v[kH];
#pragma unroll
      for (int g = 0; g < kH; ++g) {
        v[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e)
          v[g] = fmaf(qf[g][e], x[e], v[g]);
      }
      fold_heads<kH, kL / 2, kH>(v, lr);
      p[u] = ok[u] ? v[0] * a.c : kNegInf;
    }
    float mx = m_own;
#pragma unroll
    for (int u = 0; u < kU; ++u) mx = fmaxf(mx, p[u]);
    const float alpha = ex2(m_own - mx);
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u] = ok[u] ? ex2(p[u] - mx) : 0.0f;
      sum += p[u];
    }
    l_own = fmaf(alpha, l_own, sum);
    m_own = mx;
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      const float al = __shfl_sync(0xffffffffu, alpha, row0 + g * kReps);
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      uint32_t w[kW];
      if constexpr (kVec) {
        load_shared<T>(w, at(j % kStages, u, 1));
      } else {
        load_elems<T>(w, vp + slot_of(j * kU + u) * row, d - e0, ok[u]);
      }
      float x[kLaneElems];
      unpack<T>(w, x);
#pragma unroll
      for (int g = 0; g < kH; ++g) {
        const float pg = __shfl_sync(0xffffffffu, p[u], row0 + g * kReps);
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e)
          acc[g][e] = fmaf(pg, x[e], acc[g][e]);
      }
    }
  }
  if constexpr (kVec) cp_async_wait<0>();

  // every head's max and sum on every lane of the row, then the rows of
  // the warp merged: lanes kL, 2 kL, ... apart
  float m[kH], l[kH];
#pragma unroll
  for (int g = 0; g < kH; ++g) {
    m[g] = __shfl_sync(0xffffffffu, m_own, row0 + g * kReps);
    l[g] = __shfl_sync(0xffffffffu, l_own, row0 + g * kReps);
  }
#pragma unroll
  for (int off = kL; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      if (g < gn) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float wa = ex2(m[g] - mn);
        const float wb = ex2(mo - mn);
        l[g] = wa * l[g] + wb * lo;
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e)
          acc[g][e] = wa * acc[g][e] +
                      wb * __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        m[g] = mn;
      }
    }
  }
  __syncthreads();  // every warp is done with its ring
  float* sm_acc = reinterpret_cast<float*>(smem);  // [warp][head][d]
  float* sm_ml = sm_acc + kWarps * kH * d;          // [warp][head][m, l]
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < kH; ++g) {
      if (g < gn) {
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e) {
          if (e0 + e < d) sm_acc[(warp * kH + g) * d + e0 + e] = acc[g][e];
        }
        if (lr == 0) {
          sm_ml[(warp * kH + g) * 2] = m[g];
          sm_ml[(warp * kH + g) * 2 + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  // merge the warps; write the split's state
  const int64_t part =
      (static_cast<int64_t>(b) * a.KV + kvh) * gridDim.x + split;
  for (int i = threadIdx.x; i < gn * d; i += kThreads) {
    const int g = i / d;
    const int col = i - g * d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, sm_ml[(w * kH + g) * 2]);
    float num = 0.0f;
    float den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = ex2(sm_ml[(w * kH + g) * 2] - mx);
      num += wt * sm_acc[(w * kH + g) * d + col];
      den += wt * sm_ml[(w * kH + g) * 2 + 1];
    }
    a.part_acc[(part * G + g0 + g) * d + col] = num;
    if (col == 0) {
      a.part_ml[(part * G + g0 + g) * 2] = mx;
      a.part_ml[(part * G + g0 + g) * 2 + 1] = den;
    }
  }
}

// A block's sum (op = fmaxf or a + b) of one value a thread, on every
// thread; red holds kCombineThreads / 32 floats.
template <typename Op>
__device__ __forceinline__ float block_reduce(float x, float* red, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w) x = op(x, red[w]);
  return x;
}

// One block per (h, b). The threads read the splits' maxima and sums
// side by side (a split a thread at a time, so the loads overlap) and
// keep each split's weight 2^(m_s - M) in shared memory. Thread t then
// sums column t % d over the splits s with s % groups == t / d (groups =
// kCombineThreads / d), and the groups' sums are added. A head wider
// than the block (d 256) is one group: thread t sums columns t, t +
// kCombineThreads, ... over every split.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(T* __restrict__ out,
                          const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml, int nsplit,
                          int H, int KV, int d) {
  extern __shared__ float wts[];  // nsplit weights, then the reductions
  float* red = wts + nsplit;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int kvh = h / G;
  const int g = h - kvh * G;
  const int64_t base = (static_cast<int64_t>(b) * KV + kvh) * nsplit;
  auto ml = [&](int s, int i) { return part_ml[((base + s) * G + g) * 2 + i]; };
  float mx = kNegInf;
  for (int s = threadIdx.x; s < nsplit; s += kCombineThreads)
    mx = fmaxf(mx, ml(s, 0));
  mx = block_reduce(mx, red, [](float x, float y) { return fmaxf(x, y); });
  float den = 0.0f;
  for (int s = threadIdx.x; s < nsplit; s += kCombineThreads) {
    const float w = ex2(ml(s, 0) - mx);
    wts[s] = w;
    den += w * ml(s, 1);
  }
  den = block_reduce(den, red, [](float x, float y) { return x + y; });
  // block_reduce's barriers made wts visible
  T* orow = out + (static_cast<int64_t>(b) * H + h) * d;
  if (d > kCombineThreads) {
    for (int col = threadIdx.x; col < d; col += kCombineThreads) {
      float num = 0.0f;
#pragma unroll 4
      for (int s = 0; s < nsplit; ++s)
        num += wts[s] * part_acc[((base + s) * G + g) * d + col];
      orow[col] = from_f32<T>(num / fmaxf(den, 1e-30f));
    }
    return;
  }
  const int groups = kCombineThreads / d;
  const int col = threadIdx.x % d;
  const int group = threadIdx.x / d;
  float num = 0.0f;
  if (group < groups) {
#pragma unroll 4
    for (int s = group; s < nsplit; s += groups)
      num += wts[s] * part_acc[((base + s) * G + g) * d + col];
  }
  __syncthreads();  // the reductions' floats are free
  if (group < groups) red[threadIdx.x] = num;
  __syncthreads();
  if (threadIdx.x < d) {
    for (int j = 1; j < groups; ++j) num += red[j * d + threadIdx.x];
    orow[threadIdx.x] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int kH, int kL>
void launch_split(const SplitArgs<T>& args, bool vec, dim3 grid,
                  cudaStream_t stream) {
  if (vec) {
    decode_split_kernel<T, kH, kL, true>
        <<<grid, kThreads, 0, stream>>>(args);
  } else {
    decode_split_kernel<T, kH, kL, false>
        <<<grid, kThreads, 0, stream>>>(args);
  }
}

template <typename T, int kH>
void launch_heads(const SplitArgs<T>& args, bool vec, dim3 grid,
                  cudaStream_t stream) {
  if (args.d > 16 * kLaneElems) {
    launch_split<T, kH, 32>(args, vec, grid, stream);
  } else if (args.d > 8 * kLaneElems) {
    launch_split<T, kH, 16>(args, vec, grid, stream);
  } else {
    launch_split<T, kH, 8>(args, vec, grid, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(void* out, const void* q, const void* k_cache,
                   const void* v_cache, const int32_t* valid_len,
                   float* part_acc, float* part_ml, int64_t B, int64_t S,
                   int64_t H, int64_t KV, int64_t d, int64_t split_len,
                   float scale, cudaStream_t stream) {
  const int G = static_cast<int>(H / KV);
  const SplitArgs<T> args{
      part_acc, part_ml, static_cast<const T*>(q),
      static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      valid_len, static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(d),
      static_cast<int>(split_len), scale * 1.4426950408889634f};
  const bool vec = d % kLaneElems == 0 && aligned16(k_cache) &&
                   aligned16(v_cache);
  const int64_t nsplit = (S + split_len - 1) / split_len;
  const int64_t chunks = (G + kDecodeHeadChunk - 1) / kDecodeHeadChunk;
  const dim3 grid(static_cast<unsigned>(nsplit),
                  static_cast<unsigned>(KV * chunks),
                  static_cast<unsigned>(B));
  if (G == 1) {
    launch_heads<T, 1>(args, vec, grid, stream);
  } else {
    launch_heads<T, kDecodeHeadChunk>(args, vec, grid, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (nsplit + kCombineThreads);
  decode_combine_kernel<T><<<dim3(static_cast<unsigned>(H),
                                  static_cast<unsigned>(B)),
                             kCombineThreads, smem, stream>>>(
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
                                    int64_t split_len, float scale, bool bf16,
                                    cudaStream_t stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  return bf16 ? launch<__nv_bfloat16>(out, q, k_cache, v_cache, valid_len,
                                      part_acc, part_ml, B, S, H, KV, d,
                                      split_len, scale, stream)
              : launch<float>(out, q, k_cache, v_cache, valid_len, part_acc,
                              part_ml, B, S, H, KV, d, split_len, scale,
                              stream);
}
