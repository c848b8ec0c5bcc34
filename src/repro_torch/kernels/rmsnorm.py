"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w`` per row, in float32, cast
back to ``x``'s dtype.

Counterpart of ``repro/kernels/rmsnorm.py:rmsnorm`` and of its oracle
``repro/kernels/ref.py:rmsnorm_ref``. ``rmsnorm`` launches the CUDA kernel
(``csrc/rmsnorm.cu``, one warp a row) and only that: a tensor that is not
on a CUDA device is refused. ``rmsnorm_ref`` is the plain PyTorch version
(``kernels.ops`` picks between the two by the operand's device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand
from repro_torch.kernels._build import load_kernels


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; weight: (D,) float32."""
    check_cuda_operand(x, "x")
    check_cuda_operand(weight, "weight", torch.float32)
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match the "
                         f"last dimension of x {tuple(x.shape)}")
    out = torch.empty_like(x)
    load_kernels()
    torch.ops.repro_torch.rmsnorm(x, weight, out, eps)
    LAUNCH_COUNTS["rmsnorm"] += 1
    return out


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version, the formula of the reference's oracle."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
