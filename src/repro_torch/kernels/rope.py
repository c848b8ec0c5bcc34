"""Rotary position embedding (RoPE) of a layer's q and k, the half-split
layout: each row's halves (x1, x2) at position p turn by the angles
p / theta^(i / (d/2)), in float32, cast back to the input's dtype; and its
backward, the inverse rotation.

Counterpart of ``repro/models/layers.py:apply_rope`` (the JAX package
rotates in jnp; no TPU kernel). ``rope`` launches the CUDA kernel
(``csrc/rope.cu``: one pass over q and k together) and only that: a
tensor that is not on a CUDA device is refused. ``rope_ref`` is the plain
PyTorch version, the formula the model layer ran before the kernel
(``kernels.ops`` picks between the two by the operand's device); the
kernel gives its bits on the card.

``rope_bwd`` launches the same kernel with the sines negated, and
``rope_bwd_ref`` is its plain version: the same formula at minus the
angles, which equals autograd through ``rope_ref`` bit for bit.
``Rope`` is the ``autograd.Function`` over the two pairs, each picked by
the operand's device; it saves the positions only.

q is (B, Sq, H, d) and k, when given, (B, Sk, KV, d), of one dtype,
float32 or bfloat16, with d a multiple of 16 up to 256; the positions
``pos_q`` (Sq,) and ``pos_k`` (Sk,) are integer tensors on the operands'
device (``arange`` in training and prefill, the cache position in
decode), never read on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand, pick
from repro_torch.kernels._build import load_kernels

MAX_HEAD_DIM = 256
POSITION_DTYPES = (torch.int64, torch.int32)


def _dims(q: torch.Tensor, k: Optional[torch.Tensor], pos_q: torch.Tensor,
          pos_k: Optional[torch.Tensor]) -> None:
    """The shapes every route takes (the kernel's limits)."""
    d = q.shape[-1]
    if q.dim() != 4 or d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, H, d) with d "
                         f"a multiple of 16 in [16, {MAX_HEAD_DIM}]")
    if (k is None) != (pos_k is None):
        raise ValueError("k and pos_k go together")
    if k is not None and (k.dim() != 4 or k.shape[0] != q.shape[0]
                          or k.shape[3] != d):
        raise ValueError(f"k {tuple(k.shape)} must be (B, Sk, KV, d) with "
                         f"q's B and d {tuple(q.shape)}")
    for x, pos, name in ((q, pos_q, "pos_q"), (k, pos_k, "pos_k")):
        if x is None:
            continue
        if pos.shape != x.shape[1:2]:
            raise ValueError(f"{name} {tuple(pos.shape)} must be "
                             f"({x.shape[1]},)")
        if pos.dtype not in POSITION_DTYPES or pos.dtype != pos_q.dtype:
            raise TypeError(f"{name} has dtype {pos.dtype}: the positions "
                            "are int64 or int32, both of one dtype")
    if k is not None and k.dtype != q.dtype:
        raise TypeError(f"k has dtype {k.dtype}, expected q's {q.dtype}")


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, positions: torch.Tensor, theta: float,
            inverse: bool = False) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    half-split layout, in float32, cast back to x's dtype; ``inverse``
    turns by minus the angles."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    if inverse:
        sin = -sin
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_ref(q: torch.Tensor, k: Optional[torch.Tensor],
             pos_q: torch.Tensor, pos_k: Optional[torch.Tensor],
             theta: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: q and k each rotated at their positions."""
    _dims(q, k, pos_q, pos_k)
    return (_rotate(q, pos_q, theta),
            None if k is None else _rotate(k, pos_k, theta))


def rope_bwd_ref(dq: torch.Tensor, dk: Optional[torch.Tensor],
                 pos_q: torch.Tensor, pos_k: Optional[torch.Tensor],
                 theta: float
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward: the gradients turned back
    by the angles, dx1 = g1 cos + g2 sin, dx2 = g2 cos - g1 sin."""
    _dims(dq, dk, pos_q, pos_k)
    return (_rotate(dq, pos_q, theta, inverse=True),
            None if dk is None else _rotate(dk, pos_k, theta, inverse=True))


def _launch(name: str, q: torch.Tensor, k: Optional[torch.Tensor],
            pos_q: torch.Tensor, pos_k: Optional[torch.Tensor], theta: float,
            inverse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _dims(q, k, pos_q, pos_k)
    check_cuda_operand(q, "q")
    check_cuda_operand(pos_q, "pos_q", pos_q.dtype)
    if k is not None:
        check_cuda_operand(k, "k", q.dtype)
        check_cuda_operand(pos_k, "pos_k", pos_q.dtype)
    load_kernels()
    out = torch.ops.repro_torch.rope(q, k, pos_q, pos_k, theta, inverse)
    LAUNCH_COUNTS[name] += 1
    return out[0], (out[1] if k is not None else None)


def rope(q: torch.Tensor, k: Optional[torch.Tensor], pos_q: torch.Tensor,
         pos_k: Optional[torch.Tensor], theta: float
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(q', k'), k' None without k: one launch for both."""
    return _launch("rope", q, k, pos_q, pos_k, theta, inverse=False)


def rope_bwd(dq: torch.Tensor, dk: Optional[torch.Tensor],
             pos_q: torch.Tensor, pos_k: Optional[torch.Tensor], theta: float
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of q and k from those of q' and k': one launch."""
    return _launch("rope_bwd", dq, dk, pos_q, pos_k, theta, inverse=True)


class Rope(torch.autograd.Function):
    """``rope`` with its backward: the kernels on a CUDA tensor, the plain
    versions on a CPU one, the meta routes on a meta one."""

    @staticmethod
    def forward(ctx, q, k, pos_q, pos_k, theta):
        ctx.save_for_backward(pos_q, pos_k)
        ctx.theta = theta
        return pick(q, rope_ref, rope, "rope")(q, k, pos_q, pos_k, theta)

    @staticmethod
    def backward(ctx, dq, dk):
        pos_q, pos_k = ctx.saved_tensors
        bwd = pick(dq, rope_bwd_ref, rope_bwd, "rope_bwd")
        dq = dq.contiguous()
        dk = None if dk is None else dk.contiguous()
        with trace.span("op.rope_bwd"):
            gq, gk = bwd(dq, dk, pos_q, pos_k, ctx.theta)
        return gq, gk, None, None, None
