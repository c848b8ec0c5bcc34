"""Hand-written Hopper kernels of the port and their plain versions.

``LAUNCH_COUNTS`` counts kernel launches by wrapper name, for the whole
package: each wrapper bumps it right where it launches its kernel and
nowhere else, so a run can prove that its path went through the kernels
(the role ``TRACE_COUNTS`` plays in the JAX package).

``route`` and ``pick`` choose a call's version by its operand's device
alone: the plain PyTorch version on the CPU, the kernel on a CUDA
device, the shape-and-work route (``kernels.meta``) on the meta device;
any other device raises.
"""
import collections
import importlib

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


ROUTES = ("cpu", "cuda", "meta")


def route(t: torch.Tensor) -> str:
    """The version a kernel call on ``t`` takes: ``"cpu"`` (the plain
    version), ``"cuda"`` (the kernel) or ``"meta"`` (shapes and work)."""
    kind = t.device.type
    if kind not in ROUTES:
        raise ValueError(f"no kernel route for a tensor on {t.device}: the "
                         f"port's kernels take {', '.join(ROUTES)} tensors")
    return kind


def pick(t: torch.Tensor, plain, kernel, name: str):
    """``plain`` for a CPU ``t``, ``kernel`` for a CUDA one, and
    ``kernels.meta``'s ``name`` for a meta one."""
    kind = route(t)
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return kernel
    return getattr(importlib.import_module("repro_torch.kernels.meta"), name)
