"""Mamba-2 SSD chunked scan: per (b, h), the chunks of L rows in order,
each adding its intra-chunk term and the carried state's term to y, then
updating the (P, N) state; all in float32, y and the final state cast
back to x's dtype.

Counterpart of ``repro/kernels/ssd_scan.py:ssd_scan`` and of its oracle
``repro/kernels/ref.py:ssd_ref``. ``ssd_scan`` launches the CUDA kernels
(``csrc/ssd_scan.cu``: the chunks' own states, the state recurrence over
the chunks, then y, each pass spread over the (b, h, chunk) cells; the
binding makes the outputs and the float32 scratch) and only that: a
tensor that is not on a CUDA device is refused. ``ssd_scan_ref``
is the plain PyTorch version, the kernel's chunk loop batched over
(B, H) with torch products (``kernels.ops`` picks between the two by the
operand's device).

The chunk is ``min(chunk, S)`` and must divide S, as in the reference
(which asserts it): a 100-token prompt runs one chunk of 100, a 300-token
prompt with chunk 256 is refused.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand
from repro_torch.kernels._build import load_kernels


def _dims(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
          C_: torch.Tensor, chunk: int):
    """-> (B, S, H, P, N, L) with L = min(chunk, S); raises on shapes the
    reference refuses."""
    if x.dim() != 4 or B_.dim() != 4 or B_.shape != C_.shape:
        raise ValueError(f"x {tuple(x.shape)} must be (B, S, H, P) and B_, "
                         f"C_ {tuple(B_.shape)}, {tuple(C_.shape)} "
                         "(B, S, H, N)")
    Bb, S, H, P = x.shape
    if B_.shape[:3] != x.shape[:3] or dtA.shape != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)}, dtA {tuple(dtA.shape)} and "
                         f"B_ {tuple(B_.shape)} do not pair: dtA must be "
                         "(B, S, H), B_ and C_ (B, S, H, N)")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"the chunk min(chunk, S) = {L} must divide the "
                         f"sequence length S = {S} (chunk {chunk})")
    return Bb, S, H, P, B_.shape[-1], L


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P) pre-scaled by dt, float32 or bfloat16; dtA: (B, S, H)
    float32; B_/C_: (B, S, H, N) in x's dtype (groups pre-broadcast to
    heads). The kernel takes P, N <= 128 and a chunk of at most 256 (the
    binding enforces its limits). Returns (y (B, S, H, P),
    final_state (B, H, P, N)), both x's dtype."""
    L = _dims(x, dtA, B_, C_, chunk)[-1]
    check_cuda_operand(x, "x")
    check_cuda_operand(dtA, "dtA", torch.float32)
    check_cuda_operand(B_, "B_", x.dtype)
    check_cuda_operand(C_, "C_", x.dtype)
    load_kernels()
    y, final_state = torch.ops.repro_torch.ssd_scan(x, dtA, B_, C_, L)
    LAUNCH_COUNTS["ssd_scan"] += 1
    return y, final_state


def ssd_scan_ref(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, *, chunk: int = 64
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the kernel's loop over chunks, each chunk's
    (L, L), (L, P) and (P, N) products batched over (B, H), float32."""
    Bb, S, H, P, N, L = _dims(x, dtA, B_, C_, chunk)
    xs, Bs, Cs = (t.float().transpose(1, 2) for t in (x, B_, C_))  # (B,H,S,·)
    As = dtA.float().transpose(1, 2)                               # (B,H,S)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    state = x.new_zeros((Bb, H, P, N), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, L):
        xc, Bc, Cc = (t[:, :, c0:c0 + L] for t in (xs, Bs, Cs))
        A_cum = torch.cumsum(As[:, :, c0:c0 + L], dim=-1)          # (B,H,L)
        seg = A_cum[..., :, None] - A_cum[..., None, :]
        Lmat = torch.where(tril, torch.exp(seg), 0.0)
        G = Cc @ Bc.transpose(-1, -2)                               # (B,H,L,L)
        y = (G * Lmat) @ xc + (Cc @ state.transpose(-1, -2)) \
            * torch.exp(A_cum)[..., None]
        decay = torch.exp(A_cum[..., -1:] - A_cum)                  # (B,H,L)
        state = torch.exp(A_cum[..., -1])[..., None, None] * state \
            + xc.transpose(-1, -2) @ (Bc * decay[..., None])
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).contiguous()
    return y.to(x.dtype), state.to(x.dtype)
