// PyTorch binding of the replay-ring kernels: registers
// torch.ops.repro_torch.ring_write / ring_gather for CUDA tensors. The only
// source that includes PyTorch's headers, and only the light ones
// (torch/library.h, not torch/extension.h), to keep the build short.

#include <optional>

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

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

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("ring_write(Tensor(a!) data, Tensor batch, Tensor ptr, "
        "Tensor? window_start, int capacity) -> ()");
  m.def("ring_gather(Tensor data, Tensor idx, Tensor? window_start, "
        "Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(repro_torch, CUDA, m) {
  m.impl("ring_write", &ring_write);
  m.impl("ring_gather", &ring_gather);
}
