"""Data-sheet figures of one NVIDIA H100 SXM (dense rates, no sparsity,
at the full 700 W power limit), and the least time a kernel's work could
take on it. A frozen copy of ``repro_torch.launch.analysis``'s constants
and ``bound_ms``."""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # B/s
_PEAK = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}


def bound_s(work) -> Tuple[float, str]:
    """The least time the card could take for a kernel's ``Work``: its
    bytes over the HBM rate or its FLOPs over the peak of their type, the
    larger. -> (seconds, "bytes" or "operations")."""
    t_bytes = work.bytes / HBM_BW
    t_ops = work.flops / _PEAK[work.flop_type]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
