"""Replay-ring kernels: the ring write and the uniform gather.

Counterpart of ``repro/kernels/replay_ops.py``'s ``ring_write`` /
``ring_gather`` and their ``*_ref`` oracles. The kernels are CUDA C++
for Hopper (``csrc/ring_ops.cu``), built at first use by
``kernels._build``; ``ring_write`` / ``ring_gather`` here launch them and
only them: a tensor that is not on a CUDA device is refused. The plain
PyTorch versions ``ring_write_ref`` / ``ring_gather_ref`` sit beside
them with the same semantics (``kernels.ops`` picks between the two by
the operand's device).

Windows: ``data`` may hold global ring slots ``[window_start,
window_start + data.shape[0])`` of a ``capacity``-slot pool. Rows landing
outside are skipped by the write and come back as zeros from the gather.
``window_start`` and ``ptr`` are device tensors the kernels read
themselves (``None`` for the window means slot 0), so no launch waits on
the host.

``LAUNCH_COUNTS`` counts kernel launches, bumped right where a kernel is
launched and nowhere else, so a run can prove that its path went through
the kernels (the role ``TRACE_COUNTS`` plays in the JAX package).
"""
from __future__ import annotations

import collections
from typing import Optional, Union

import torch

from repro_torch.kernels._build import load_kernels

LAUNCH_COUNTS: collections.Counter = collections.Counter()

Window = Union[None, int, torch.Tensor]


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _as2d(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> (rows, features); scalar rows get one feature."""
    return x.reshape(x.shape[0], -1)


def _check_cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")


def _window_tensor(window_start: Window, device) -> Optional[torch.Tensor]:
    """The kernels' form: ``None`` (slot 0) or a device int32 scalar."""
    if window_start is None or isinstance(window_start, torch.Tensor):
        return window_start
    return torch.tensor(window_start, dtype=torch.int32, device=device)


def _window_long(window_start: Window, device) -> torch.Tensor:
    """The plain versions' form: an int64 scalar on ``device``."""
    return torch.as_tensor(0 if window_start is None else window_start,
                           dtype=torch.int64, device=device)


# --------------------------------------------------------------------------- #
# ring write
# --------------------------------------------------------------------------- #

def ring_write(data: torch.Tensor, batch: torch.Tensor, ptr: torch.Tensor,
               *, capacity: Optional[int] = None,
               window_start: Window = None) -> torch.Tensor:
    """Write ``batch`` (n, ...) into ``data`` at ring slots ``(ptr + i) %
    capacity`` with the CUDA kernel, in place; returns ``data``.

    ``ptr`` is a device int32 scalar. ``capacity`` defaults to
    ``data.shape[0]`` (the whole pool). Requires n <= capacity
    (``replay.buffer.write_plan`` keeps the newest rows of a larger
    write)."""
    rows_local, n = data.shape[0], batch.shape[0]
    cap = rows_local if capacity is None else capacity
    if n > cap:
        raise ValueError(f"ring_write of {n} rows into capacity {cap}")
    _check_cuda_operand(data, "data", torch.float32)
    _check_cuda_operand(batch, "batch", data.dtype)
    _check_cuda_operand(ptr, "ptr", torch.int32)
    if batch.shape[1:] != data.shape[1:]:
        raise ValueError(f"batch rows {tuple(batch.shape[1:])} do not match "
                         f"data rows {tuple(data.shape[1:])}")
    if n == 0:
        return data
    load_kernels()
    torch.ops.repro_torch.ring_write(
        _as2d(data), _as2d(batch), ptr,
        _window_tensor(window_start, data.device), cap)
    LAUNCH_COUNTS["ring_write"] += 1
    return data


def ring_write_ref(data: torch.Tensor, batch: torch.Tensor, ptr, *,
                   capacity: Optional[int] = None,
                   window_start: Window = None) -> torch.Tensor:
    """Plain PyTorch ring write (``index_copy_`` on the in-window rows),
    in place; returns ``data``. Same semantics as ``ring_write``."""
    rows_local, n = data.shape[0], batch.shape[0]
    cap = rows_local if capacity is None else capacity
    if n > cap:
        raise ValueError(f"ring_write of {n} rows into capacity {cap}")
    if batch.dtype != data.dtype:
        raise TypeError(f"batch has dtype {batch.dtype}, expected "
                        f"{data.dtype}")
    dest = (torch.as_tensor(ptr, device=data.device).long()
            + torch.arange(n, device=data.device)) % cap
    local = dest - _window_long(window_start, data.device)
    inside = (local >= 0) & (local < rows_local)
    data.index_copy_(0, local[inside], batch[inside])
    return data


# --------------------------------------------------------------------------- #
# ring gather
# --------------------------------------------------------------------------- #

def ring_gather(data: torch.Tensor, idx: torch.Tensor, *,
                window_start: Window = None) -> torch.Tensor:
    """``data[idx - window_start]`` for a (batch,) int32 vector of global
    ring slots, with the CUDA kernel; out-of-window rows (negative
    padding included) come back as zeros."""
    _check_cuda_operand(data, "data", torch.float32)
    _check_cuda_operand(idx, "idx", torch.int32)
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-d, got shape {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0],) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if idx.shape[0] == 0:
        return out
    load_kernels()
    torch.ops.repro_torch.ring_gather(
        _as2d(data), idx, _window_tensor(window_start, data.device),
        _as2d(out))
    LAUNCH_COUNTS["ring_gather"] += 1
    return out


def ring_gather_ref(data: torch.Tensor, idx: torch.Tensor, *,
                    window_start: Window = None) -> torch.Tensor:
    """Plain PyTorch gather (``index_select`` plus a mask); zeros for
    out-of-window rows. Same semantics as ``ring_gather``."""
    local = idx.long() - _window_long(window_start, data.device)
    inside = (local >= 0) & (local < data.shape[0])
    rows = data.index_select(0, local.clamp(0, max(data.shape[0] - 1, 0)))
    mask = inside.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=data.dtype,
                                               device=data.device))
