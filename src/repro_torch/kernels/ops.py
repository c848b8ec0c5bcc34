"""Public replay ops: the counterpart of ``repro/kernels/ops.py``'s
``ring_write`` / ``ring_gather`` / ``per_topk`` / ``priority_scatter``.

Which version runs is decided by the operand's device, never by what the
machine has: a CUDA tensor goes to the hand-written kernel (which raises
on anything it does not take), a CPU tensor to the plain PyTorch
version. There is no switch and no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import replay_ops as _replay


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
