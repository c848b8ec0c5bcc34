// PyTorch binding of the replay kernels: registers
// torch.ops.repro_torch.ring_write / ring_gather / per_topk /
// priority_scatter for CUDA tensors. The only source that includes
// PyTorch's headers, and only the light ones (torch/library.h, not
// torch/extension.h), to keep the build short.

#include <optional>

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "per_ops.h"
#include "ring_ops.h"

namespace {

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
  TORCH_CHECK(batch.size(0) <= capacity, "ring_write of ", batch.size(0),
              " rows into capacity ", capacity);
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
  TORCH_CHECK(k >= 1 && k <= rows, "per_topk of k=", k, " from a ", rows,
              "-row window");
  TORCH_CHECK(rows < 0x7fffffff, "per_topk needs rows < 2**31 - 1");
  TORCH_CHECK(scores.size(0) == k && idx.size(0) == k,
              "scores and idx must hold k entries");
  TORCH_CHECK(scratch.size(0) >= per_topk_scratch_keys(rows, k),
              "scratch holds ", scratch.size(0), " keys, needs ",
              per_topk_scratch_keys(rows, k));
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
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("ring_write", &ring_write);
  m.impl("ring_gather", &ring_gather);
  m.impl("per_topk", &per_topk);
  m.impl("priority_scatter", &priority_scatter);
}
