"""kernel-launch fixture: an uncounted launch, a count with no launch, a
fallback around a launch, a module-scope build import, and a route picked
by what the machine has."""
import torch
import triton

from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.kernels._build import load_kernels


def uncounted(x):
    load_kernels()
    return torch.ops.repro_torch.rmsnorm(x)


def counted_without_launch(x):
    LAUNCH_COUNTS["rmsnorm"] += 1
    return x


def with_fallback(x):
    try:
        load_kernels()
        out = torch.ops.repro_torch.rmsnorm(x)
        LAUNCH_COUNTS["rmsnorm"] += 1
        return out
    except RuntimeError:
        return x * 2


def by_machine(x):
    if torch.cuda.is_available():
        return x
    return x + 1
