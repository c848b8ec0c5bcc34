"""Replay kernels: the ring write, the uniform gather, the fused PER
score + top-k selection and the priority scatter.

Counterpart of ``repro/kernels/replay_ops.py``'s ``ring_write`` /
``ring_gather`` / ``per_topk`` / ``priority_scatter`` and their ``*_ref``
oracles. The kernels are CUDA C++ for Hopper (``csrc/ring_ops.cu``,
``csrc/per_ops.cu``), built at first use by ``kernels._build``; the
wrappers here launch them and only them: a tensor that is not on a CUDA
device is refused. The plain PyTorch versions (``*_ref``) sit beside
them with the same semantics (``kernels.ops`` picks between the two by
the operand's device).

Windows: ``data`` may hold global ring slots ``[window_start,
window_start + data.shape[0])`` of a ``capacity``-slot pool. Rows landing
outside are skipped by the write and come back as zeros from the gather.
``window_start`` and ``ptr`` are device tensors the kernels read
themselves (``None`` for the window means slot 0), so no launch waits on
the host.

``LAUNCH_COUNTS`` is the package's one launch counter
(``repro_torch.kernels``), re-exported here with ``reset_launch_counts``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import (LAUNCH_COUNTS, check_cuda_operand,  # noqa: F401
                                 reset_launch_counts)
from repro_torch.kernels._build import load_kernels

Window = Union[None, int, torch.Tensor]


def _as2d(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> (rows, features); scalar rows get one feature."""
    return x.reshape(x.shape[0], -1)


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
    check_cuda_operand(data, "data", torch.float32)
    check_cuda_operand(batch, "batch", data.dtype)
    check_cuda_operand(ptr, "ptr", torch.int32)
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
    check_cuda_operand(data, "data", torch.float32)
    check_cuda_operand(idx, "idx", torch.int32)
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


# --------------------------------------------------------------------------- #
# PER: fused Gumbel score + top-k selection
# --------------------------------------------------------------------------- #

# Index carried by top-k slots whose score is -inf (fewer live rows in the
# window than k): it stays out of every live index range, and PER sampling
# never dereferences such a slot (draws past the live count cycle).
IDX_SENTINEL = 2**31 - 1
# keys one block of the CUDA top-k sorts (``csrc/per_ops.h``)
PER_TOPK_TILE = 4096


def per_scores_ref(priorities: torch.Tensor, gumbel: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """Gumbel-top-k scores ``alpha * log(max(p, 1e-12)) + g``, a true
    ``-inf`` where ``p == 0`` (an unwritten or zeroed row can never be
    drawn). The product and the sum round separately, as in the kernel."""
    logp = torch.where(priorities > 0.0,
                       alpha * torch.log(torch.clamp(priorities, min=1e-12)),
                       float("-inf"))
    return logp + gumbel


def _check_topk(rows: int, k: int):
    if not 0 <= k <= rows:
        raise ValueError(f"per_topk of k={k} from a {rows}-row window")
    if rows >= IDX_SENTINEL:
        raise ValueError(f"per_topk needs rows < 2**31 - 1 (int32 row "
                         f"indices), got {rows}")


def per_topk_scratch_keys(rows: int, k: int) -> int:
    """int64 keys of scratch the CUDA top-k needs: two buffers of
    ``tiles * min(k, tile)`` keys, the tile count rounded up to a power of
    two (``per_topk_scratch_keys`` in ``csrc/per_ops.cu``)."""
    tiles = 1 << max(0, (-(-rows // PER_TOPK_TILE) - 1).bit_length())
    return 2 * tiles * min(k, PER_TOPK_TILE)


def per_topk(priorities: torch.Tensor, gumbel: torch.Tensor, alpha: float,
             k: int, *, window_start: Window = None):
    """Fused PER selection with the CUDA kernel: the k best Gumbel scores
    over the (rows,) priority window.

    Returns ``(scores (k,) f32, global_idx (k,) int32)``, sorted by
    descending score with the lower row first among equal scores
    (``jax.lax.top_k``'s order); indices are offset by ``window_start``,
    and slots scoring ``-inf`` carry ``IDX_SENTINEL``. ``k > rows``
    raises."""
    (rows,) = priorities.shape
    _check_topk(rows, k)
    check_cuda_operand(priorities, "priorities", torch.float32)
    check_cuda_operand(gumbel, "gumbel", torch.float32)
    if gumbel.shape != priorities.shape:
        raise ValueError(f"gumbel {tuple(gumbel.shape)} does not match "
                         f"priorities {tuple(priorities.shape)}")
    dev = priorities.device
    scores = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    if k == 0:
        return scores, idx
    scratch = torch.empty((per_topk_scratch_keys(rows, k),),
                          dtype=torch.int64, device=dev)
    load_kernels()
    torch.ops.repro_torch.per_topk(priorities, gumbel,
                                   _window_tensor(window_start, dev),
                                   scratch, scores, idx, float(alpha), k)
    LAUNCH_COUNTS["per_topk"] += 1
    return scores, idx


def per_topk_ref(priorities: torch.Tensor, gumbel: torch.Tensor,
                 alpha: float, k: int, *, window_start: Window = None):
    """Plain PyTorch ``per_topk``: a stable descending sort of the scores
    (``torch.topk`` leaves the order of ties unspecified), its first k,
    and ``IDX_SENTINEL`` on the ``-inf`` slots, so kernel and plain
    version compare bit for bit."""
    (rows,) = priorities.shape
    _check_topk(rows, k)
    v, i = torch.sort(per_scores_ref(priorities, gumbel, alpha),
                      descending=True, stable=True)
    v, i = v[:k], i[:k] + _window_long(window_start, priorities.device)
    idx = torch.where(torch.isneginf(v), IDX_SENTINEL, i)
    return v, idx.to(torch.int32)


# --------------------------------------------------------------------------- #
# PER: priority scatter
# --------------------------------------------------------------------------- #

def _check_scatter(priorities, idx, values):
    for name, x in (("priorities", priorities), ("idx", idx),
                    ("values", values)):
        if x.dim() != 1:
            raise ValueError(f"{name} must be 1-d, got {tuple(x.shape)}")
    if idx.shape != values.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and values "
                         f"{tuple(values.shape)} differ")


def priority_scatter(priorities: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor, *,
                     window_start: Window = None) -> torch.Tensor:
    """``priorities[idx - window_start] = values`` for the in-window
    indices, in place, with the CUDA kernel; returns ``priorities``. On a
    repeated index the last write wins, as in the TPU kernel's sequential
    loop; out-of-window indices are skipped."""
    _check_scatter(priorities, idx, values)
    check_cuda_operand(priorities, "priorities", torch.float32)
    check_cuda_operand(idx, "idx", torch.int32)
    check_cuda_operand(values, "values", torch.float32)
    if idx.shape[0] == 0:
        return priorities
    owner = torch.empty(priorities.shape, dtype=torch.int32,
                        device=priorities.device)
    load_kernels()
    torch.ops.repro_torch.priority_scatter(
        priorities, idx, values,
        _window_tensor(window_start, priorities.device), owner)
    LAUNCH_COUNTS["priority_scatter"] += 1
    return priorities


def priority_scatter_ref(priorities: torch.Tensor, idx: torch.Tensor,
                         values: torch.Tensor, *,
                         window_start: Window = None) -> torch.Tensor:
    """Plain PyTorch ``priority_scatter``, in place: the last draw of each
    in-window row is found with ``scatter_reduce_(..., "amax")`` over the
    draws' positions, and only those draws write (``index_put_`` with
    repeated indices leaves the winner unspecified)."""
    _check_scatter(priorities, idx, values)
    rows_local, dev = priorities.shape[0], priorities.device
    local = idx.long() - _window_long(window_start, dev)
    inside = (local >= 0) & (local < rows_local)
    dest = torch.where(inside, local, rows_local)     # a spare slot
    pos = torch.arange(idx.shape[0], device=dev)
    owner = torch.full((rows_local + 1,), -1, dtype=torch.long, device=dev)
    owner.scatter_reduce_(0, dest, pos, "amax")
    wins = inside & (owner[dest] == pos)
    priorities[local[wins]] = values[wins].to(priorities.dtype)
    return priorities
