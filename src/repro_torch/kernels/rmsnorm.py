"""RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w`` per row, in float32, cast
back to ``x``'s dtype, and its backward.

Counterpart of ``repro/kernels/rmsnorm.py:rmsnorm`` and of its oracle
``repro/kernels/ref.py:rmsnorm_ref``. ``rmsnorm`` launches the CUDA kernel
(``csrc/rmsnorm.cu``, one warp a row) and only that: a tensor that is not
on a CUDA device is refused. ``rmsnorm_ref`` is the plain PyTorch version
(``kernels.ops`` picks between the two by the operand's device).

``rmsnorm_bwd`` launches the backward kernels (``csrc/rmsnorm.cu``: dx a
row and per-block partial sums of dw, then their sum in block order; one
count a call) and ``rmsnorm_bwd_ref`` is its plain version, written as
the formulas. ``RMSNorm`` is the ``autograd.Function`` over the two
pairs, each picked by the operand's device: the TPU kernel had no
backward (the JAX package trains through its jnp path).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand, pick
from repro_torch.kernels._build import load_kernels


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; weight: (D,) float32."""
    check_cuda_operand(x, "x")
    check_cuda_operand(weight, "weight", torch.float32)
    _check_row_operands(x, weight)
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


def _check_row_operands(x: torch.Tensor, weight: torch.Tensor) -> None:
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match the "
                         f"last dimension of x {tuple(x.shape)}")


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dy: (..., D) of one dtype, float32 or bfloat16; weight: (D,)
    float32. Returns (dx like x, dw (D,) float32 summed over the rows);
    two runs give the same bits."""
    check_cuda_operand(x, "x")
    check_cuda_operand(dy, "dy", x.dtype)
    check_cuda_operand(weight, "weight", torch.float32)
    _check_row_operands(x, weight)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    load_kernels()
    dx, dw = torch.ops.repro_torch.rmsnorm_bwd(x, weight, dy, eps)
    LAUNCH_COUNTS["rmsnorm_bwd"] += 1
    return dx, dw


def rmsnorm_bwd_ref(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                    *, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in float32: with g = dy w and r = rsqrt(
    mean(x^2) + eps), dx = r g - x r^3 mean(g x) and dw = sum over rows of
    dy x r."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = dyf * weight.float()
    dx = r * g - xf * (r * r * r) * torch.mean(g * xf, dim=-1, keepdim=True)
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw


class RMSNorm(torch.autograd.Function):
    """``rmsnorm`` with its backward: the kernels on a CUDA tensor, the
    plain versions on a CPU one, the meta routes on a meta one."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return pick(x, rmsnorm_ref, rmsnorm, "rmsnorm")(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        bwd = pick(x, rmsnorm_bwd_ref, rmsnorm_bwd, "rmsnorm_bwd")
        dy = dy.contiguous()
        with trace.span("op.rmsnorm_bwd"):
            dx, dw = bwd(x, weight, dy, eps=ctx.eps)
        return dx, dw, None
