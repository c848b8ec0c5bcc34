"""suppression fixture: an allow without a reason is itself a finding."""
import torch


def f():
    # tracelint: allow[generator]
    return torch.randn((2,))
