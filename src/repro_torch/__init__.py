"""PyTorch + CUDA port of the Spreeze reproduction (``repro``).

Laid out module for module like ``repro``; imports ``torch`` and numpy
only. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that explicit request it
raises (``resolve_device``) rather than quietly running on the CPU.
"""
import contextlib
import subprocess

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


def exact_float32(device) -> None:
    """Turn TF32 off for float32 products on ``device`` when it is a CUDA
    device (the reference is float32 end to end). The backends' switches
    are process-wide, so this module is their one owner; a no-op
    elsewhere."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``device: cpu`` for a CPU run."""
    if torch.device(device).type != "cuda":
        return "device: cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def sync_debug_mode(device, mode):
    """Run the block under ``torch.cuda.set_sync_debug_mode(mode)`` and
    restore the previous mode on the way out, also when the block
    raises. ``"error"`` makes any operation that waits for the card
    (``.item()``, a copy from pageable host memory, ``nonzero``, a
    synchronise) raise; ``0`` lifts it. The mode is process-wide. A
    no-op for a device other than ``cuda``, where no mode exists."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
