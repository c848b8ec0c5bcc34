// PyTorch binding of the port's kernels: registers
// torch.ops.repro_torch.ring_write / ring_gather / per_topk /
// priority_scatter / per_scores and the bench baselines
// ring_write_rowloop / ring_gather_rowloop (replay) and rmsnorm /
// flash_attention /
// decode_attention / ssd_scan (the LM model) for CUDA tensors. The only
// source that includes PyTorch's headers, and only the light ones
// (torch/library.h, not torch/extension.h), to keep the build short.

#include <optional>
#include <string>

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "model_ops.h"
#include "per_ops.h"
#include "ring_ops.h"

namespace {

// An integer for a TORCH_CHECK message. Streaming an integer into the
// message (c10::str, an ostringstream) crashes the process with SIGSEGV
// instead of raising, with this library built by g++ 13 against PyTorch
// 2.11's wheel; a std::string streams safely.
std::string num(int64_t v) { return std::to_string(v); }

void check_operand(const at::Tensor& t, const char* name,
                   c10::ScalarType dtype) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has dtype ", t.scalar_type(),
              ", expected ", dtype);
}

const int32_t* window_ptr(const std::optional<at::Tensor>& window_start) {
  if (!window_start.has_value()) return nullptr;
  check_operand(*window_start, "window_start", at::kInt);
  TORCH_CHECK(window_start->numel() == 1, "window_start must be a scalar");
  return window_start->data_ptr<int32_t>();
}

int64_t row_width(const at::Tensor& t) {
  return t.size(0) ? t.numel() / t.size(0) : 0;
}

void ring_write(at::Tensor data, const at::Tensor& batch,
                const at::Tensor& ptr,
                const std::optional<at::Tensor>& window_start,
                int64_t capacity) {
  check_operand(data, "data", at::kFloat);
  check_operand(batch, "batch", at::kFloat);
  check_operand(ptr, "ptr", at::kInt);
  TORCH_CHECK(ptr.numel() == 1, "ptr must be a scalar");
  TORCH_CHECK(batch.size(0) <= capacity, "ring_write of ",
              num(batch.size(0)), " rows into capacity ", num(capacity));
  TORCH_CHECK(row_width(batch) == row_width(data),
              "batch and data rows differ in width");
  const c10::cuda::CUDAGuard guard(data.device());
  launch_ring_write(data.data_ptr<float>(), batch.data_ptr<float>(),
                    ptr.data_ptr<int32_t>(), window_ptr(window_start),
                    batch.size(0), row_width(data), capacity, data.size(0),
                    c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ring_gather(const at::Tensor& data, const at::Tensor& idx,
                 const std::optional<at::Tensor>& window_start,
                 at::Tensor out) {
  check_operand(data, "data", at::kFloat);
  check_operand(idx, "idx", at::kInt);
  check_operand(out, "out", at::kFloat);
  TORCH_CHECK(out.size(0) == idx.numel() && row_width(out) == row_width(data),
              "out must be (len(idx), row width of data)");
  const c10::cuda::CUDAGuard guard(data.device());
  launch_ring_gather(out.data_ptr<float>(), data.data_ptr<float>(),
                     idx.data_ptr<int32_t>(), window_ptr(window_start),
                     idx.numel(), row_width(data), data.size(0),
                     c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void check_vector(const at::Tensor& t, const char* name,
                  c10::ScalarType dtype) {
  check_operand(t, name, dtype);
  TORCH_CHECK(t.dim() == 1, name, " must be 1-d");
}

void ring_write_rowloop(at::Tensor data, const at::Tensor& batch,
                        const at::Tensor& ptr) {
  check_operand(data, "data", at::kFloat);
  check_operand(batch, "batch", at::kFloat);
  check_operand(ptr, "ptr", at::kInt);
  TORCH_CHECK(ptr.numel() == 1, "ptr must be a scalar");
  TORCH_CHECK(batch.size(0) <= data.size(0), "ring_write_rowloop of ",
              num(batch.size(0)), " rows into capacity ", num(data.size(0)));
  TORCH_CHECK(row_width(batch) == row_width(data),
              "batch and data rows differ in width");
  if (batch.size(0) == 0) return;
  const c10::cuda::CUDAGuard guard(data.device());
  launch_ring_write_rowloop(data.data_ptr<float>(), batch.data_ptr<float>(),
                            ptr.data_ptr<int32_t>(), batch.size(0),
                            row_width(data), data.size(0),
                            c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ring_gather_rowloop(const at::Tensor& data, const at::Tensor& idx,
                         at::Tensor out) {
  check_operand(data, "data", at::kFloat);
  check_vector(idx, "idx", at::kInt);
  check_operand(out, "out", at::kFloat);
  TORCH_CHECK(data.dim() >= 1 && data.size(0) >= 1,
              "ring_gather_rowloop needs at least 1 data row, got ",
              num(data.dim() ? data.size(0) : 0));
  TORCH_CHECK(out.size(0) == idx.numel() && row_width(out) == row_width(data),
              "out must be (len(idx), row width of data)");
  if (idx.numel() == 0) return;
  const c10::cuda::CUDAGuard guard(data.device());
  launch_ring_gather_rowloop(out.data_ptr<float>(), data.data_ptr<float>(),
                             idx.data_ptr<int32_t>(), idx.numel(),
                             row_width(data), data.size(0),
                             c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void per_scores(const at::Tensor& priorities, const at::Tensor& gumbel,
                at::Tensor out, double alpha) {
  check_vector(priorities, "priorities", at::kFloat);
  check_vector(gumbel, "gumbel", at::kFloat);
  check_vector(out, "out", at::kFloat);
  const int64_t rows = priorities.size(0);
  TORCH_CHECK(gumbel.size(0) == rows && out.size(0) == rows, "gumbel has ",
              num(gumbel.size(0)), " rows and out ", num(out.size(0)),
              ", priorities ", num(rows));
  if (rows == 0) return;
  const c10::cuda::CUDAGuard guard(priorities.device());
  launch_per_scores(out.data_ptr<float>(), priorities.data_ptr<float>(),
                    gumbel.data_ptr<float>(), static_cast<float>(alpha),
                    rows, c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void per_topk(const at::Tensor& priorities, const at::Tensor& gumbel,
              const std::optional<at::Tensor>& window_start,
              at::Tensor scratch, at::Tensor scores, at::Tensor idx,
              double alpha, int64_t k) {
  check_vector(priorities, "priorities", at::kFloat);
  check_vector(gumbel, "gumbel", at::kFloat);
  check_vector(scratch, "scratch", at::kLong);
  check_vector(scores, "scores", at::kFloat);
  check_vector(idx, "idx", at::kInt);
  const int64_t rows = priorities.size(0);
  TORCH_CHECK(gumbel.size(0) == rows, "gumbel and priorities differ");
  TORCH_CHECK(k >= 1 && k <= rows, "per_topk of k=", num(k), " from a ",
              num(rows), "-row window");
  TORCH_CHECK(rows < 0x7fffffff, "per_topk needs rows < 2**31 - 1");
  TORCH_CHECK(scores.size(0) == k && idx.size(0) == k,
              "scores and idx must hold k entries");
  TORCH_CHECK(scratch.size(0) >= per_topk_scratch_keys(rows, k),
              "scratch holds ", num(scratch.size(0)), " keys, needs ",
              num(per_topk_scratch_keys(rows, k)));
  const c10::cuda::CUDAGuard guard(priorities.device());
  launch_per_topk(scores.data_ptr<float>(), idx.data_ptr<int32_t>(),
                  priorities.data_ptr<float>(), gumbel.data_ptr<float>(),
                  window_ptr(window_start), static_cast<float>(alpha), rows,
                  k, reinterpret_cast<uint64_t*>(scratch.data_ptr<int64_t>()),
                  c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void priority_scatter(at::Tensor priorities, const at::Tensor& idx,
                      const at::Tensor& values,
                      const std::optional<at::Tensor>& window_start,
                      at::Tensor owner) {
  check_vector(priorities, "priorities", at::kFloat);
  check_vector(idx, "idx", at::kInt);
  check_vector(values, "values", at::kFloat);
  check_vector(owner, "owner", at::kInt);
  TORCH_CHECK(values.size(0) == idx.size(0), "idx and values differ");
  TORCH_CHECK(idx.size(0) < 0x7fffffff, "priority_scatter needs k < 2**31");
  TORCH_CHECK(owner.size(0) >= priorities.size(0),
              "owner must hold a slot per priority row");
  const c10::cuda::CUDAGuard guard(priorities.device());
  launch_priority_scatter(priorities.data_ptr<float>(),
                          idx.data_ptr<int32_t>(), values.data_ptr<float>(),
                          window_ptr(window_start), idx.size(0),
                          priorities.size(0), owner.data_ptr<int32_t>(),
                          c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The model kernels take float32 or bfloat16 activations; returns whether
// t is bfloat16.
bool check_activation(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.scalar_type() == at::kFloat ||
                  t.scalar_type() == at::kBFloat16,
              name, " has dtype ", t.scalar_type(),
              ", expected float32 or bfloat16");
  check_operand(t, name, t.scalar_type());
  return t.scalar_type() == at::kBFloat16;
}

void rmsnorm(const at::Tensor& x, const at::Tensor& weight, at::Tensor out,
             double eps) {
  const bool bf16 = check_activation(x, "x");
  check_operand(out, "out", x.scalar_type());
  check_vector(weight, "weight", at::kFloat);
  TORCH_CHECK(x.dim() >= 1 && weight.size(0) == x.size(-1),
              "weight must have x's last dimension");
  TORCH_CHECK(out.sizes() == x.sizes(), "out must have x's shape");
  const int64_t dim = x.size(-1);
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(launch_rmsnorm(out.data_ptr(), x.data_ptr(),
                                weight.data_ptr<float>(),
                                dim ? x.numel() / dim : 0, dim,
                                static_cast<float>(eps), bf16,
                                c10::cuda::getCurrentCUDAStream()));
}

void check_attention_dims(int64_t H, int64_t KV, int64_t d) {
  TORCH_CHECK(KV > 0 && H % KV == 0, "query heads ", num(H),
              " are not a multiple of KV heads ", num(KV));
  TORCH_CHECK(d >= 1 && d <= kMaxHeadDim, "head_dim ", num(d),
              " not in [1, ", num(kMaxHeadDim), "]");
}

void flash_attention(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, at::Tensor out, bool causal,
                     std::optional<int64_t> window, double scale) {
  const bool bf16 = check_activation(q, "q");
  check_operand(k, "k", q.scalar_type());
  check_operand(v, "v", q.scalar_type());
  check_operand(out, "out", q.scalar_type());
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4, "q and k must be 4-d");
  TORCH_CHECK(k.sizes() == v.sizes(), "k and v differ in shape");
  TORCH_CHECK(out.sizes() == q.sizes(), "out must have q's shape");
  const int64_t B = q.size(0), Sq = q.size(1), H = q.size(2), d = q.size(3);
  const int64_t Sk = k.size(1), KV = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(3) == d, "k must be (B, Sk, KV, d)");
  check_attention_dims(H, KV, d);
  TORCH_CHECK(Sq < (1 << 30) && Sk < (1 << 30), "sequence too long");
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention(
      out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk,
      H, KV, d, static_cast<float>(scale), causal, window.has_value(),
      window.value_or(0), bf16, c10::cuda::getCurrentCUDAStream()));
}

void decode_attention(const at::Tensor& q, const at::Tensor& k_cache,
                      const at::Tensor& v_cache, const at::Tensor& valid_len,
                      at::Tensor out, double scale) {
  const bool bf16 = check_activation(q, "q");
  check_operand(k_cache, "k_cache", q.scalar_type());
  check_operand(v_cache, "v_cache", q.scalar_type());
  check_operand(out, "out", q.scalar_type());
  check_operand(valid_len, "valid_len", at::kInt);
  TORCH_CHECK(valid_len.numel() == 1, "valid_len must be a scalar");
  TORCH_CHECK(q.dim() == 3 && k_cache.dim() == 4, "q must be (B, H, d), "
              "the caches (B, S, KV, d)");
  TORCH_CHECK(k_cache.sizes() == v_cache.sizes(), "caches differ in shape");
  TORCH_CHECK(out.sizes() == q.sizes(), "out must have q's shape");
  const int64_t B = q.size(0), H = q.size(1), d = q.size(2);
  const int64_t S = k_cache.size(1), KV = k_cache.size(2);
  TORCH_CHECK(k_cache.size(0) == B && k_cache.size(3) == d,
              "caches must be (B, S, KV, d)");
  check_attention_dims(H, KV, d);
  TORCH_CHECK(H / KV <= kMaxDecodeGroup, "decode_attention takes at most ",
              num(kMaxDecodeGroup), " query heads per KV head");
  TORCH_CHECK(S >= 1 && S < (1 << 30), "cache length ", num(S),
              " out of range");
  const c10::cuda::CUDAGuard guard(q.device());
  // The first pass's per-split partial results (model_ops.h), from the
  // caching allocator on the current stream.
  const int64_t splits = (S + kDecodeSplit - 1) / kDecodeSplit;
  const auto f32 = q.options().dtype(at::kFloat);
  at::Tensor part_acc = q.new_empty({B, KV, splits, H / KV, d}, f32);
  at::Tensor part_ml = q.new_empty({B, KV, splits, H / KV, 2}, f32);
  C10_CUDA_CHECK(launch_decode_attention(
      out.data_ptr(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      valid_len.data_ptr<int32_t>(), part_acc.data_ptr<float>(),
      part_ml.data_ptr<float>(), B, S, H, KV, d, static_cast<float>(scale),
      bf16, c10::cuda::getCurrentCUDAStream()));
}

void ssd_scan(const at::Tensor& x, const at::Tensor& dtA, const at::Tensor& B_,
              const at::Tensor& C_, at::Tensor y, at::Tensor final_state,
              int64_t chunk) {
  const bool bf16 = check_activation(x, "x");
  check_operand(dtA, "dtA", at::kFloat);
  check_operand(B_, "B_", x.scalar_type());
  check_operand(C_, "C_", x.scalar_type());
  check_operand(y, "y", x.scalar_type());
  check_operand(final_state, "final_state", x.scalar_type());
  TORCH_CHECK(x.dim() == 4 && B_.dim() == 4, "x must be (B, S, H, P) and "
              "B_, C_ (B, S, H, N)");
  const int64_t B = x.size(0), S = x.size(1), H = x.size(2), P = x.size(3);
  const int64_t N = B_.size(3);
  TORCH_CHECK(B_.sizes() == C_.sizes(), "B_ and C_ differ in shape");
  TORCH_CHECK(B_.size(0) == B && B_.size(1) == S && B_.size(2) == H,
              "B_ must be (B, S, H, N)");
  TORCH_CHECK(dtA.dim() == 3 && dtA.size(0) == B && dtA.size(1) == S &&
                  dtA.size(2) == H,
              "dtA must be (B, S, H)");
  TORCH_CHECK(y.sizes() == x.sizes(), "y must have x's shape");
  TORCH_CHECK(final_state.dim() == 4 && final_state.size(0) == B &&
                  final_state.size(1) == H && final_state.size(2) == P &&
                  final_state.size(3) == N,
              "final_state must be (B, H, P, N)");
  TORCH_CHECK(P >= 1 && P <= kMaxSsdDim && N >= 1 && N <= kMaxSsdDim,
              "ssd_scan takes P and N in [1, ", num(kMaxSsdDim), "]");
  TORCH_CHECK(chunk >= 1 && chunk <= kMaxSsdChunk && S % chunk == 0,
              "ssd_scan needs a chunk in [1, ", num(kMaxSsdChunk),
              "] that divides S");
  TORCH_CHECK(B < 65536 && H < 65536 && S * H < (int64_t{1} << 31),
              "ssd_scan shape out of range");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(launch_ssd_scan(
      y.data_ptr(), final_state.data_ptr(), x.data_ptr(),
      dtA.data_ptr<float>(), B_.data_ptr(), C_.data_ptr(), B, S, H, P, N,
      chunk, bf16, c10::cuda::getCurrentCUDAStream()));
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("ring_write(Tensor(a!) data, Tensor batch, Tensor ptr, "
        "Tensor? window_start, int capacity) -> ()");
  m.def("ring_gather(Tensor data, Tensor idx, Tensor? window_start, "
        "Tensor(a!) out) -> ()");
  m.def("per_topk(Tensor priorities, Tensor gumbel, Tensor? window_start, "
        "Tensor(a!) scratch, Tensor(b!) scores, Tensor(c!) idx, "
        "float alpha, int k) -> ()");
  m.def("priority_scatter(Tensor(a!) priorities, Tensor idx, "
        "Tensor values, Tensor? window_start, Tensor(b!) owner) -> ()");
  m.def("per_scores(Tensor priorities, Tensor gumbel, Tensor(a!) out, "
        "float alpha) -> ()");
  m.def("ring_write_rowloop(Tensor(a!) data, Tensor batch, Tensor ptr) "
        "-> ()");
  m.def("ring_gather_rowloop(Tensor data, Tensor idx, Tensor(a!) out) "
        "-> ()");
  m.def("rmsnorm(Tensor x, Tensor weight, Tensor(a!) out, float eps) -> ()");
  m.def("flash_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) out, "
        "bool causal, int? window, float scale) -> ()");
  m.def("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
        "Tensor valid_len, Tensor(a!) out, float scale) -> ()");
  m.def("ssd_scan(Tensor x, Tensor dtA, Tensor B_, Tensor C_, "
        "Tensor(a!) y, Tensor(b!) final_state, int chunk) -> ()");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("ring_write", &ring_write);
  m.impl("ring_gather", &ring_gather);
  m.impl("per_topk", &per_topk);
  m.impl("priority_scatter", &priority_scatter);
  m.impl("per_scores", &per_scores);
  m.impl("ring_write_rowloop", &ring_write_rowloop);
  m.impl("ring_gather_rowloop", &ring_gather_rowloop);
  m.impl("rmsnorm", &rmsnorm);
  m.impl("flash_attention", &flash_attention);
  m.impl("decode_attention", &decode_attention);
  m.impl("ssd_scan", &ssd_scan);
}
