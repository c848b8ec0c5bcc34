"""Public kernel ops: the counterpart of ``repro/kernels/ops.py``'s
replay ops (``ring_write`` / ``ring_gather`` / ``per_topk`` /
``priority_scatter``), the bench baselines (``per_scores`` /
``ring_write_rowloop`` / ``ring_gather_rowloop``) and model ops (``rmsnorm`` / ``flash_attention`` /
``decode_attention`` / ``ssd_scan``).

Which version runs is decided by the operand's device, never by what the
machine has: a CUDA tensor goes to the hand-written kernel (which raises
on anything it does not take), a CPU tensor to the plain PyTorch
version. There is no switch and no fallback between the two: where the
reference chose between its jnp path and its Pallas kernels with
``use_pallas``, the port's model code always calls these.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import replay_ops as _replay
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd


def ring_write(data: torch.Tensor, batch: torch.Tensor, ptr: torch.Tensor,
               **kw) -> torch.Tensor:
    """In-place ring write of (n, ...) rows at ``(ptr + i) % capacity``."""
    if data.device.type == "cpu":
        return _replay.ring_write_ref(data, batch, ptr, **kw)
    return _replay.ring_write(data, batch, ptr, **kw)


def ring_gather(data: torch.Tensor, idx: torch.Tensor, **kw
                ) -> torch.Tensor:
    """Batched random row gather from the replay ring."""
    if data.device.type == "cpu":
        return _replay.ring_gather_ref(data, idx, **kw)
    return _replay.ring_gather(data, idx, **kw)


def per_topk(priorities: torch.Tensor, gumbel: torch.Tensor, alpha: float,
             k: int, **kw):
    """Fused PER Gumbel score + top-k -> (scores desc, global idx)."""
    if priorities.device.type == "cpu":
        return _replay.per_topk_ref(priorities, gumbel, alpha, k, **kw)
    return _replay.per_topk(priorities, gumbel, alpha, k, **kw)


def priority_scatter(priorities: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor, **kw) -> torch.Tensor:
    """In-place ``priorities[idx] = values``, the last draw winning."""
    if priorities.device.type == "cpu":
        return _replay.priority_scatter_ref(priorities, idx, values, **kw)
    return _replay.priority_scatter(priorities, idx, values, **kw)


def per_scores(priorities: torch.Tensor, gumbel: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """Gumbel-top-k scores of every row of the priority vector."""
    if priorities.device.type == "cpu":
        return _replay.per_scores_ref(priorities, gumbel, alpha)
    return _replay.per_scores(priorities, gumbel, alpha)


def ring_write_rowloop(data: torch.Tensor, batch: torch.Tensor,
                       ptr: torch.Tensor) -> torch.Tensor:
    """The row-at-a-time in-place ring write (no window)."""
    if data.device.type == "cpu":
        return _replay.ring_write_ref(data, batch, ptr)
    return _replay.ring_write_rowloop(data, batch, ptr)


def ring_gather_rowloop(data: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """The row-at-a-time gather (no window, indices wrapped and clamped)."""
    if data.device.type == "cpu":
        return _replay.ring_gather_rowloop_ref(data, idx)
    return _replay.ring_gather_rowloop(data, idx)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """Row-wise RMSNorm of (..., D) in float32, cast back to x's dtype."""
    if x.device.type == "cpu":
        return _rms.rmsnorm_ref(x, weight, eps=eps)
    return _rms.rmsnorm(x, weight, eps=eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """(B,Sq,H,d) x (B,Sk,KV,d)^2 -> (B,Sq,H,d)."""
    if q.device.type == "cpu":
        return _fa.attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """(B,H,d) x (B,S,KV,d)^2 -> (B,H,d); ``valid_len`` a scalar tensor."""
    if q.device.type == "cpu":
        return _dec.decode_attention_ref(q, k_cache, v_cache, valid_len)
    return _dec.decode_attention(q, k_cache, v_cache, valid_len)


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan: (B,S,H,P), (B,S,H), (B,S,H,N)^2 ->
    (y (B,S,H,P), final_state (B,H,P,N)); chunks of min(chunk, S)."""
    if x.device.type == "cpu":
        return _ssd.ssd_scan_ref(x, dtA, B_, C_, chunk=chunk)
    return _ssd.ssd_scan(x, dtA, B_, C_, chunk=chunk)
