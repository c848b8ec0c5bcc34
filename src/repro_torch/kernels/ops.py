"""Public replay-ring ops: the counterpart of ``repro/kernels/ops.py``'s
``ring_write`` / ``ring_gather``.

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
