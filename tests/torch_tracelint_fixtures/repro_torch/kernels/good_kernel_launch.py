"""kernel-launch control: a counted launch, the build imported where the
kernel is first called, the route picked by the operand's device."""
import torch

from repro_torch.kernels import LAUNCH_COUNTS, pick
from repro_torch.kernels._build import load_kernels


def rmsnorm(x):
    load_kernels()
    out = torch.ops.repro_torch.rmsnorm(x)
    LAUNCH_COUNTS["rmsnorm"] += 1
    return out


def triton_kernel(x):
    import triton  # noqa: F401  (built at first call)
    return x


def routed(x):
    return pick(x, lambda t: t, rmsnorm, "rmsnorm")(x)
