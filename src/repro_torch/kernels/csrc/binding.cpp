// PyTorch binding of the port's kernels: registers
// torch.ops.repro_torch.ring_write / ring_gather / per_topk /
// priority_scatter / per_scores and the bench baselines
// ring_write_rowloop / ring_gather_rowloop (replay) and rmsnorm /
// flash_attention /
// decode_attention / ssd_scan (the LM model) for CUDA tensors. The only
// source that includes PyTorch's headers, and only the light ones
// (torch/library.h, not torch/extension.h), to keep the build short.

#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

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

// The SMs of t's card, which the kernels spread their blocks over.
int sm_count(const at::Tensor& t) {
  int sms = 0;
  C10_CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        t.get_device()));
  return sms;
}

int64_t row_width(const at::Tensor& t) {
  return t.size(0) ? t.numel() / t.size(0) : 0;
}

// A row's shape for a TORCH_CHECK message, "(2, 3)" for a (n, 2, 3)
// tensor, its sizes formatted with num().
std::string row_shape(const at::Tensor& t) {
  std::string s = "(";
  for (int64_t d = 1; d < t.dim(); ++d) {
    s += (d > 1 ? ", " : "") + num(t.size(d));
  }
  return s + ")";
}

// One launch writes every field of a round at the same ring slots: the
// fields share ptr, the window, the capacity and rows_local, and each
// may have its own row shape. floor_mod picks the row-at-a-time
// baseline's index rule.
void write_fields(c10::ArrayRef<at::Tensor> data,
                  c10::ArrayRef<at::Tensor> batch, const at::Tensor& ptr,
                  const std::optional<at::Tensor>& window_start,
                  int64_t capacity, bool floor_mod) {
  const int64_t nfields = static_cast<int64_t>(data.size());
  TORCH_CHECK(nfields >= 1 && nfields <= kMaxRingFields, "ring_write of ",
              num(nfields), " fields: takes 1 to ", num(kMaxRingFields));
  TORCH_CHECK(static_cast<int64_t>(batch.size()) == nfields, "ring_write "
              "of ", num(static_cast<int64_t>(batch.size())),
              " batches into ", num(nfields), " fields");
  check_operand(ptr, "ptr", at::kInt);
  TORCH_CHECK(ptr.numel() == 1, "ptr must be a scalar");
  const int64_t rows_local = data[0].dim() ? data[0].size(0) : 0;
  const int64_t n = batch[0].dim() ? batch[0].size(0) : 0;
  TORCH_CHECK(n <= capacity, "ring_write of ", num(n),
              " rows into capacity ", num(capacity));
  RingFields fields{};
  for (int64_t k = 0; k < nfields; ++k) {
    check_operand(data[k], "data", at::kFloat);
    check_operand(batch[k], "batch", at::kFloat);
    TORCH_CHECK(data[k].device() == ptr.device() &&
                    batch[k].device() == ptr.device(),
                "field ", num(k), " is not on ptr's device");
    TORCH_CHECK(data[k].dim() >= 1 && data[k].size(0) == rows_local,
                "field ", num(k), " does not hold field 0's ",
                num(rows_local), " rows");
    TORCH_CHECK(batch[k].dim() >= 1 && batch[k].size(0) == n, "field ",
                num(k), "'s batch does not hold field 0's ", num(n),
                " rows");
    TORCH_CHECK(data[k].sizes().slice(1) == batch[k].sizes().slice(1),
                "field ", num(k), ": batch rows ", row_shape(batch[k]),
                " do not match data rows ", row_shape(data[k]));
    fields.data[k] = data[k].data_ptr<float>();
    fields.batch[k] = batch[k].data_ptr<float>();
    fields.width[k] = row_width(data[k]);
  }
  const c10::cuda::CUDAGuard guard(ptr.device());
  launch_ring_write(fields, static_cast<int>(nfields),
                    ptr.data_ptr<int32_t>(), window_ptr(window_start), n,
                    capacity, rows_local, floor_mod,
                    c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ring_write(c10::ArrayRef<at::Tensor> data,
                c10::ArrayRef<at::Tensor> batch, const at::Tensor& ptr,
                const std::optional<at::Tensor>& window_start,
                int64_t capacity) {
  write_fields(data, batch, ptr, window_start, capacity, false);
}

// One launch gathers every field of an update at the same indices: the
// fields share idx, the window and rows_local, and each may have its own
// row shape. Returns each field's (len(idx),) + data[k].shape[1:] rows,
// allocated here: made in Python, the outputs took more host time than
// the rest of the call. clamp picks the row-at-a-time baseline's index
// rule.
std::vector<at::Tensor> gather_fields(
    c10::ArrayRef<at::Tensor> data, const at::Tensor& idx,
    const std::optional<at::Tensor>& window_start, bool clamp) {
  const int64_t nfields = static_cast<int64_t>(data.size());
  TORCH_CHECK(nfields >= 1 && nfields <= kMaxRingFields, "ring_gather of ",
              num(nfields), " fields: takes 1 to ", num(kMaxRingFields));
  check_operand(idx, "idx", at::kInt);
  TORCH_CHECK(idx.dim() == 1, "idx must be 1-d");
  const int32_t* lo = window_ptr(window_start);
  TORCH_CHECK(!window_start.has_value() ||
                  window_start->device() == idx.device(),
              "window_start is not on idx's device");
  const int64_t bsz = idx.size(0);
  const int64_t rows_local = data[0].dim() ? data[0].size(0) : 0;
  if (clamp) {
    TORCH_CHECK(rows_local >= 1, "ring_gather_rowloop needs at least 1 "
                "data row, got ", num(rows_local));
  }
  const c10::cuda::CUDAGuard guard(idx.device());
  std::vector<at::Tensor> out;
  out.reserve(nfields);
  GatherFields fields{};
  for (int64_t k = 0; k < nfields; ++k) {
    check_operand(data[k], "data", at::kFloat);
    TORCH_CHECK(data[k].device() == idx.device(),
                "a field is not on idx's device");
    TORCH_CHECK(data[k].dim() >= 1 && data[k].size(0) == rows_local,
                "field ", num(k), " does not hold field 0's ",
                num(rows_local), " rows");
    std::vector<int64_t> shape(data[k].sizes().begin(),
                               data[k].sizes().end());
    shape[0] = bsz;
    out.push_back(data[k].new_empty(shape));
    fields.data[k] = data[k].data_ptr<float>();
    fields.out[k] = out.back().data_ptr<float>();
    fields.width[k] = row_width(data[k]);
  }
  launch_ring_gather(fields, static_cast<int>(nfields),
                     idx.data_ptr<int32_t>(), lo, bsz, rows_local, clamp,
                     c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

std::vector<at::Tensor> ring_gather(
    c10::ArrayRef<at::Tensor> data, const at::Tensor& idx,
    const std::optional<at::Tensor>& window_start) {
  return gather_fields(data, idx, window_start, false);
}

void check_vector(const at::Tensor& t, const char* name,
                  c10::ScalarType dtype) {
  check_operand(t, name, dtype);
  TORCH_CHECK(t.dim() == 1, name, " must be 1-d");
}

// The row-at-a-time baseline's write: one field, no window, the pool's
// rows as the capacity and the slot taken mod rows as a floor.
void ring_write_rowloop(at::Tensor data, const at::Tensor& batch,
                        const at::Tensor& ptr) {
  write_fields(data, batch, ptr, std::nullopt, data.dim() ? data.size(0) : 0,
               true);
}

// The row-at-a-time baseline's gather: one field, no window, a negative
// index taken from the end once and the rest clamped into the pool.
at::Tensor ring_gather_rowloop(const at::Tensor& data,
                               const at::Tensor& idx) {
  return gather_fields(data, idx, std::nullopt, true)[0];
}

// The two (rows,) vectors of a PER op on one device; returns rows.
int64_t check_per_vectors(const at::Tensor& priorities,
                          const at::Tensor& gumbel) {
  check_vector(priorities, "priorities", at::kFloat);
  check_vector(gumbel, "gumbel", at::kFloat);
  const int64_t rows = priorities.size(0);
  TORCH_CHECK(gumbel.size(0) == rows, "gumbel has ", num(gumbel.size(0)),
              " rows, priorities ", num(rows));
  TORCH_CHECK(gumbel.device() == priorities.device(),
              "gumbel is not on priorities' device");
  return rows;
}

// The scores, allocated here: made in Python, the output and its checks
// took more host time than the launch.
at::Tensor per_scores(const at::Tensor& priorities, const at::Tensor& gumbel,
                      double alpha) {
  const int64_t rows = check_per_vectors(priorities, gumbel);
  const c10::cuda::CUDAGuard guard(priorities.device());
  at::Tensor out = priorities.new_empty({rows});
  if (rows == 0) return out;
  launch_per_scores(out.data_ptr<float>(), priorities.data_ptr<float>(),
                    gumbel.data_ptr<float>(), static_cast<float>(alpha),
                    rows, c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// per_topk's state for the current stream of t's device (per_ops.h): made
// zeroed at the stream's first call and left zeroed by every call. The
// map is never destroyed, so no tensor outlives the allocator at exit.
const at::Tensor& topk_state(const at::Tensor& t, cudaStream_t stream) {
  static std::mutex mu;
  static auto* states =
      new std::map<std::pair<int, cudaStream_t>, at::Tensor>();
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(static_cast<int>(t.get_device()), stream);
  auto it = states->find(key);
  if (it == states->end()) {
    it = states->emplace(key, t.new_zeros({per_topk_state_words()},
                                          t.options().dtype(at::kInt)))
             .first;
  }
  return it->second;
}

// The k best scores and their global rows, both allocated here with the
// scratch (per_topk_scratch_keys), so the Python wrapper allocates
// nothing.
std::tuple<at::Tensor, at::Tensor> per_topk(
    const at::Tensor& priorities, const at::Tensor& gumbel,
    const std::optional<at::Tensor>& window_start, double alpha,
    int64_t k) {
  const int64_t rows = check_per_vectors(priorities, gumbel);
  TORCH_CHECK(k >= 0 && k <= rows, "per_topk of k=", num(k), " from a ",
              num(rows), "-row window");
  TORCH_CHECK(rows < 0x7fffffff, "per_topk needs rows < 2**31 - 1");
  const int32_t* lo = window_ptr(window_start);
  TORCH_CHECK(!window_start.has_value() ||
                  window_start->device() == priorities.device(),
              "window_start is not on priorities' device");
  const c10::cuda::CUDAGuard guard(priorities.device());
  at::Tensor scores = priorities.new_empty({k});
  at::Tensor idx = priorities.new_empty({k}, priorities.options().dtype(
                                                 at::kInt));
  if (k == 0) return {scores, idx};
  at::Tensor scratch = priorities.new_empty(
      {per_topk_scratch_keys(rows, k)},
      priorities.options().dtype(at::kLong));
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream();
  const at::Tensor& state = topk_state(priorities, stream);
  C10_CUDA_CHECK(launch_per_topk(
      scores.data_ptr<float>(), idx.data_ptr<int32_t>(),
      priorities.data_ptr<float>(), gumbel.data_ptr<float>(), lo,
      static_cast<float>(alpha), rows, k,
      reinterpret_cast<uint64_t*>(scratch.data_ptr<int64_t>()),
      reinterpret_cast<uint32_t*>(state.data_ptr<int32_t>()),
      sm_count(priorities), stream));
  return {scores, idx};
}

void priority_scatter(at::Tensor priorities, const at::Tensor& idx,
                      const at::Tensor& values,
                      const std::optional<at::Tensor>& window_start) {
  check_vector(priorities, "priorities", at::kFloat);
  check_vector(idx, "idx", at::kInt);
  check_vector(values, "values", at::kFloat);
  TORCH_CHECK(values.size(0) == idx.size(0), "idx and values differ");
  TORCH_CHECK(idx.size(0) < 0x7fffffff, "priority_scatter needs k < 2**31");
  const c10::cuda::CUDAGuard guard(priorities.device());
  launch_priority_scatter(priorities.data_ptr<float>(),
                          idx.data_ptr<int32_t>(), values.data_ptr<float>(),
                          window_ptr(window_start), idx.size(0),
                          priorities.size(0), sm_count(priorities),
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
  const int64_t split_len = decode_split_len(B, S, KV, H / KV,
                                             sm_count(q));
  const int64_t splits = (S + split_len - 1) / split_len;
  const auto f32 = q.options().dtype(at::kFloat);
  at::Tensor part_acc = q.new_empty({B, KV, splits, H / KV, d}, f32);
  at::Tensor part_ml = q.new_empty({B, KV, splits, H / KV, 2}, f32);
  C10_CUDA_CHECK(launch_decode_attention(
      out.data_ptr(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      valid_len.data_ptr<int32_t>(), part_acc.data_ptr<float>(),
      part_ml.data_ptr<float>(), B, S, H, KV, d, split_len,
      static_cast<float>(scale), bf16, c10::cuda::getCurrentCUDAStream()));
}

std::vector<at::Tensor> ssd_scan(const at::Tensor& x, const at::Tensor& dtA,
                                 const at::Tensor& B_, const at::Tensor& C_,
                                 int64_t chunk) {
  const bool bf16 = check_activation(x, "x");
  check_operand(dtA, "dtA", at::kFloat);
  check_operand(B_, "B_", x.scalar_type());
  check_operand(C_, "C_", x.scalar_type());
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
  TORCH_CHECK(P >= 1 && P <= kMaxSsdDim && N >= 1 && N <= kMaxSsdDim,
              "ssd_scan takes P and N in [1, ", num(kMaxSsdDim), "]");
  TORCH_CHECK(chunk >= 1 && chunk <= kMaxSsdChunk && S % chunk == 0,
              "ssd_scan needs a chunk in [1, ", num(kMaxSsdChunk),
              "] that divides S");
  TORCH_CHECK(B < 65536 && H < 65536 && S * H < (int64_t{1} << 31) &&
                  B * H < (int64_t{1} << 31),
              "ssd_scan shape out of range");
  const c10::cuda::CUDAGuard guard(x.device());
  // the outputs, and the float32 scratch of the three passes (model_ops.h),
  // from the caching allocator on the current stream
  at::Tensor y = x.new_empty(x.sizes());
  at::Tensor final_state = x.new_empty({B, H, P, N});
  const auto f32 = x.options().dtype(at::kFloat);
  at::Tensor acum = x.new_empty({B, H, S}, f32);
  at::Tensor states = x.new_empty({B, H, S / chunk, P, N}, f32);
  C10_CUDA_CHECK(launch_ssd_scan(
      y.data_ptr(), final_state.data_ptr(), x.data_ptr(),
      dtA.data_ptr<float>(), B_.data_ptr(), C_.data_ptr(),
      acum.data_ptr<float>(), states.data_ptr<float>(), B, S, H, P, N, chunk,
      bf16, c10::cuda::getCurrentCUDAStream()));
  return {y, final_state};
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("ring_write(Tensor(a!)[] data, Tensor[] batch, Tensor ptr, "
        "Tensor? window_start, int capacity) -> ()");
  m.def("ring_gather(Tensor[] data, Tensor idx, Tensor? window_start) "
        "-> Tensor[]");
  m.def("per_topk(Tensor priorities, Tensor gumbel, Tensor? window_start, "
        "float alpha, int k) -> (Tensor, Tensor)");
  m.def("priority_scatter(Tensor(a!) priorities, Tensor idx, "
        "Tensor values, Tensor? window_start) -> ()");
  m.def("per_scores(Tensor priorities, Tensor gumbel, float alpha) "
        "-> Tensor");
  m.def("ring_write_rowloop(Tensor(a!) data, Tensor batch, Tensor ptr) "
        "-> ()");
  m.def("ring_gather_rowloop(Tensor data, Tensor idx) -> Tensor");
  m.def("rmsnorm(Tensor x, Tensor weight, Tensor(a!) out, float eps) -> ()");
  m.def("flash_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) out, "
        "bool causal, int? window, float scale) -> ()");
  m.def("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
        "Tensor valid_len, Tensor(a!) out, float scale) -> ()");
  m.def("ssd_scan(Tensor x, Tensor dtA, Tensor B_, Tensor C_, int chunk) "
        "-> Tensor[]");
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
