"""Replay kernels: the ring write (one launch for every field of a
round), the uniform gather (one launch for every field of an update),
the fused PER score + top-k selection, the priority scatter, and the
bench baselines (the PER score pass and the row-at-a-time ring write and
gather).

Counterpart of ``repro/kernels/replay_ops.py``'s ``ring_write`` (here
also ``ring_write_fields``, several fields at the same slots) /
``ring_gather`` (here also ``ring_gather_fields``, several fields at the
same indices) / ``per_topk`` / ``priority_scatter`` / ``per_scores`` /
``ring_write_rowloop`` / ``ring_gather_rowloop``, their ``*_ref`` oracles
and ``merge_topk_candidates``. The kernels are CUDA C++ for Hopper
(``csrc/ring_ops.cu``,
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

from typing import List, Optional, Sequence, Union

import torch

from repro_torch.kernels import (LAUNCH_COUNTS, check_cuda_operand,  # noqa: F401
                                 reset_launch_counts)
from repro_torch.kernels._build import load_kernels

Window = Union[None, int, torch.Tensor]
# fields one ring-write or ring-gather launch takes (``kMaxRingFields`` in
# ``csrc/ring_ops.h``, checked by the binding); the plain versions of the
# gather refuse the same counts
MAX_RING_FIELDS = 8


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

def _check_write(data, batch, cap: int) -> bool:
    """The checks of a one-field ring write whose error types callers
    rely on (the binding makes the rest, and raises RuntimeError); False
    when there is nothing to write."""
    if not data.is_cuda:
        raise ValueError(f"data must be a CUDA tensor, got {data.device}")
    if batch.shape[0] > cap:
        raise ValueError(f"ring_write of {batch.shape[0]} rows into "
                         f"capacity {cap}")
    if batch.dtype != data.dtype:
        raise TypeError(f"batch has dtype {batch.dtype}, expected "
                        f"{data.dtype}")
    if not batch.is_contiguous():
        raise ValueError("batch must be contiguous")
    return batch.shape[0] > 0


def ring_write_fields(datas: Sequence[torch.Tensor],
                      batches: Sequence[torch.Tensor], ptr: torch.Tensor,
                      *, capacity: Optional[int] = None,
                      window_start: Window = None):
    """Write each ``batches[k]`` (n, ...) into ``datas[k]`` at ring slots
    ``(ptr + i) % capacity``, in place, with ONE launch of the CUDA
    kernel for all the fields (at most 8); returns ``datas``.

    The fields share ``ptr`` (a device int32 scalar), the window, the
    capacity (default: the pools' rows) and n; each has its own row
    width. Requires n <= capacity. The binding checks every operand and
    raises ``RuntimeError``; only a pool off the card is refused here,
    before anything is built."""
    data0 = datas[0]
    if not data0.is_cuda:
        raise ValueError(f"data must be a CUDA tensor, got {data0.device}")
    if batches[0].shape[0] == 0:
        return datas
    load_kernels()
    torch.ops.repro_torch.ring_write(
        datas, batches, ptr, _window_tensor(window_start, data0.device),
        data0.shape[0] if capacity is None else capacity)
    LAUNCH_COUNTS["ring_write"] += 1
    return datas


def ring_write(data: torch.Tensor, batch: torch.Tensor, ptr: torch.Tensor,
               *, capacity: Optional[int] = None,
               window_start: Window = None) -> torch.Tensor:
    """Write ``batch`` (n, ...) into ``data`` at ring slots ``(ptr + i) %
    capacity`` with the CUDA kernel, in place; returns ``data``. A
    one-field ``ring_write_fields``.

    ``ptr`` is a device int32 scalar. ``capacity`` defaults to
    ``data.shape[0]`` (the whole pool). Requires n <= capacity
    (``replay.buffer.write_plan`` keeps the newest rows of a larger
    write)."""
    cap = data.shape[0] if capacity is None else capacity
    if _check_write(data, batch, cap):
        ring_write_fields([data], [batch], ptr, capacity=cap,
                          window_start=window_start)
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
    if batch.shape[1:] != data.shape[1:]:
        raise ValueError(f"batch rows {tuple(batch.shape[1:])} do not match "
                         f"data rows {tuple(data.shape[1:])}")
    dest = (torch.as_tensor(ptr, device=data.device).long()
            + torch.arange(n, device=data.device)) % cap
    local = dest - _window_long(window_start, data.device)
    inside = (local >= 0) & (local < rows_local)
    data.index_copy_(0, local[inside], batch[inside])
    return data


def ring_write_fields_ref(datas: Sequence[torch.Tensor],
                          batches: Sequence[torch.Tensor], ptr, *,
                          capacity: Optional[int] = None,
                          window_start: Window = None):
    """Plain PyTorch ``ring_write_fields``: ``ring_write_ref`` field by
    field, in place; returns ``datas``."""
    if len(datas) != len(batches):
        raise ValueError(f"ring_write of {len(batches)} batches into "
                         f"{len(datas)} fields")
    for data, batch in zip(datas, batches):
        ring_write_ref(data, batch, ptr, capacity=capacity,
                       window_start=window_start)
    return datas


# --------------------------------------------------------------------------- #
# ring gather
# --------------------------------------------------------------------------- #

def ring_gather_fields(datas: Sequence[torch.Tensor], idx: torch.Tensor,
                       *, window_start: Window = None) -> List[torch.Tensor]:
    """``data[idx - window_start]`` for each pool of ``datas`` and a
    (batch,) int32 vector of global ring slots, with ONE launch of the
    CUDA kernel for all the fields (at most 8); out-of-window rows
    (negative padding included) come back as zeros.

    The fields share ``idx``, the window and their rows; each has its own
    row shape, and its output is ``(len(idx),) + data.shape[1:]``, made by
    the binding. The binding checks every operand and raises
    ``RuntimeError``; only a pool off the card is refused here, before
    anything is built."""
    data0 = datas[0]
    if not data0.is_cuda:
        raise ValueError(f"data must be a CUDA tensor, got {data0.device}")
    load_kernels()
    outs = torch.ops.repro_torch.ring_gather(
        datas, idx, _window_tensor(window_start, data0.device))
    if len(idx):
        LAUNCH_COUNTS["ring_gather"] += 1
    return outs


def ring_gather(data: torch.Tensor, idx: torch.Tensor, *,
                window_start: Window = None) -> torch.Tensor:
    """``data[idx - window_start]`` for a (batch,) int32 vector of global
    ring slots, with the CUDA kernel; out-of-window rows (negative
    padding included) come back as zeros. A one-field
    ``ring_gather_fields``."""
    if not data.is_cuda:
        raise ValueError(f"data must be a CUDA tensor, got {data.device}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx has dtype {idx.dtype}, expected torch.int32")
    return ring_gather_fields([data], idx, window_start=window_start)[0]


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


def ring_gather_fields_ref(datas: Sequence[torch.Tensor], idx: torch.Tensor,
                           *, window_start: Window = None
                           ) -> List[torch.Tensor]:
    """Plain PyTorch ``ring_gather_fields``: ``ring_gather_ref`` field by
    field; 1 to 8 fields, as the kernel's binding takes."""
    if not 1 <= len(datas) <= MAX_RING_FIELDS:
        raise ValueError(f"ring_gather of {len(datas)} fields: takes 1 to "
                         f"{MAX_RING_FIELDS}")
    return [ring_gather_ref(d, idx, window_start=window_start)
            for d in datas]


# --------------------------------------------------------------------------- #
# PER: fused Gumbel score + top-k selection
# --------------------------------------------------------------------------- #

# Index carried by top-k slots whose score is -inf (fewer live rows in the
# window than k): it stays out of every live index range, and PER sampling
# never dereferences such a slot (draws past the live count cycle).
IDX_SENTINEL = 2**31 - 1


def per_scores_ref(priorities: torch.Tensor, gumbel: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """Gumbel-top-k scores ``alpha * log(max(p, 1e-12)) + g``, a true
    ``-inf`` where ``p == 0`` (an unwritten or zeroed row can never be
    drawn). The product and the sum round separately, as in the kernel."""
    logp = torch.where(priorities > 0.0,
                       alpha * torch.log(torch.clamp(priorities, min=1e-12)),
                       float("-inf"))
    return logp + gumbel


def per_scores(priorities: torch.Tensor, gumbel: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """The Gumbel-top-k scores of every row (``per_scores_ref``) with the
    CUDA kernel, bit for bit; the caller takes a top-k of them. The
    binding makes the output and checks dtypes and layout (raising
    ``RuntimeError``); refused here: a tensor off the card and a shape
    mismatch."""
    shape = priorities.shape
    if not priorities.is_cuda:
        raise ValueError(f"priorities must be a CUDA tensor, got "
                         f"{priorities.device}")
    if len(shape) != 1 or gumbel.shape != shape:
        raise ValueError(f"priorities {tuple(shape)} and gumbel "
                         f"{tuple(gumbel.shape)} must be one (rows,) shape")
    load_kernels()
    # tracelint: allow[host-transfer] -- alpha is a Python number
    out = torch.ops.repro_torch.per_scores(priorities, gumbel, float(alpha))
    if shape[0]:
        LAUNCH_COUNTS["per_scores"] += 1
    return out


def merge_topk_candidates(cand_scores: torch.Tensor, cand_idx: torch.Tensor,
                          k: int):
    """Reduce per-window candidates, concatenated in window order, to the
    global top-k: a stable descending sort, so equal scores keep the
    earlier candidate first (``jax.lax.top_k``'s order, which makes the
    merge equal the dense top-k). Plain PyTorch: no kernel."""
    v, pos = torch.sort(cand_scores, descending=True, stable=True)
    return v[:k], cand_idx[pos[:k]]


def _check_topk(rows: int, k: int):
    if not 0 <= k <= rows:
        raise ValueError(f"per_topk of k={k} from a {rows}-row window")
    if rows >= IDX_SENTINEL:
        raise ValueError(f"per_topk needs rows < 2**31 - 1 (int32 row "
                         f"indices), got {rows}")


def per_topk(priorities: torch.Tensor, gumbel: torch.Tensor, alpha: float,
             k: int, *, window_start: Window = None):
    """Fused PER selection with the CUDA kernel: the k best Gumbel scores
    over the (rows,) priority window.

    Returns ``(scores (k,) f32, global_idx (k,) int32)``, sorted by
    descending score with the lower row first among equal scores
    (``jax.lax.top_k``'s order); indices are offset by ``window_start``,
    and slots scoring ``-inf`` carry ``IDX_SENTINEL``. ``k > rows``
    raises. The binding makes the outputs and the scratch, and checks
    the rest (raising ``RuntimeError``)."""
    (rows,) = priorities.shape
    _check_topk(rows, k)
    check_cuda_operand(priorities, "priorities", torch.float32)
    check_cuda_operand(gumbel, "gumbel", torch.float32)
    if gumbel.shape != priorities.shape:
        raise ValueError(f"gumbel {tuple(gumbel.shape)} does not match "
                         f"priorities {tuple(priorities.shape)}")
    load_kernels()
    alpha = float(alpha)  # tracelint: allow[host-transfer] -- a Python number
    scores, idx = torch.ops.repro_torch.per_topk(
        priorities, gumbel, _window_tensor(window_start, priorities.device),
        alpha, k)
    if k:
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
    load_kernels()
    torch.ops.repro_torch.priority_scatter(
        priorities, idx, values,
        _window_tensor(window_start, priorities.device))
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


# --------------------------------------------------------------------------- #
# The row-at-a-time ring kernels: the bench baselines
# --------------------------------------------------------------------------- #

def ring_write_rowloop(data: torch.Tensor, batch: torch.Tensor,
                       ptr: torch.Tensor) -> torch.Tensor:
    """The row-at-a-time kernel's ring write, in place, with the CUDA
    ring-write kernel on one field: row i of ``batch`` (n, ...) into slot
    ``(ptr + i) % data.shape[0]``, the remainder taken as a floor; no
    window. ``ptr`` is a device int32 scalar; n > capacity raises. Plain
    version: ``ring_write_ref`` with no window."""
    if _check_write(data, batch, data.shape[0]):
        load_kernels()
        torch.ops.repro_torch.ring_write_rowloop(data, batch, ptr)
        LAUNCH_COUNTS["ring_write_rowloop"] += 1
    return data


def _check_rowloop_gather(data: torch.Tensor, idx: torch.Tensor):
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-d, got shape {tuple(idx.shape)}")
    if data.dim() == 0 or data.shape[0] == 0:
        raise ValueError("ring_gather_rowloop needs at least one data row")


def ring_gather_rowloop(data: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """The row-at-a-time kernel's gather, with the CUDA ring-gather kernel
    on one field: ``out[i] = data[idx[i]]``, no window. Indices outside
    the pool follow ``ring_gather_rowloop_ref``. The binding checks the
    rest and raises ``RuntimeError``."""
    if not data.is_cuda:
        raise ValueError(f"data must be a CUDA tensor, got {data.device}")
    if data.dtype != torch.float32:
        raise TypeError(f"data has dtype {data.dtype}, expected "
                        "torch.float32")
    if data.dim() == 0 or data.shape[0] == 0:
        raise ValueError("ring_gather_rowloop needs at least one data row")
    load_kernels()
    out = torch.ops.repro_torch.ring_gather_rowloop(data, idx)
    if len(idx):
        LAUNCH_COUNTS["ring_gather_rowloop"] += 1
    return out


def ring_gather_rowloop_ref(data: torch.Tensor, idx: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch ``ring_gather_rowloop``. The TPU kernel reads
    ``data[idx[i]]`` with no bounds check; run by the Pallas interpreter
    (the reference's oracle on a CPU), a negative index counts from the
    end once and the rest is clamped into the pool. That rule is kept
    here and in the kernel, so no index reads outside ``data``."""
    _check_rowloop_gather(data, idx)
    rows = data.shape[0]
    j = idx.long()
    j = torch.where(j < 0, j + rows, j).clamp(0, rows - 1)
    return data.index_select(0, j)
