"""PyTorch + CUDA port of the Spreeze reproduction (``repro``).

Laid out module for module like ``repro``; imports ``torch`` and numpy
only. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that explicit request it
raises (``resolve_device``) rather than quietly running on the CPU.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point builds its tensors on. ``cuda`` (the
    default) raises when no GPU is present: running on the CPU is only
    ever the caller's explicit choice."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
