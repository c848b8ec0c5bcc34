"""Hand-written Hopper kernels of the port and their plain versions.

``LAUNCH_COUNTS`` counts kernel launches by wrapper name, for the whole
package: each wrapper bumps it right where it launches its kernel and
nowhere else, so a run can prove that its path went through the kernels
(the role ``TRACE_COUNTS`` plays in the JAX package).
"""
import collections

import torch

LAUNCH_COUNTS: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


ACTIVATION_DTYPES = (torch.float32, torch.bfloat16)


def check_cuda_operand(t: torch.Tensor, name: str, dtype=None):
    """A kernel's operand: a contiguous CUDA tensor of ``dtype`` (for the
    model kernels' activations, float32 or bfloat16 when not given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is None and t.dtype not in ACTIVATION_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or "
                        "bfloat16")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
