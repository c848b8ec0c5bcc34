"""The kernels' routes on the ``meta`` device: shapes and work, no values.

``kernels.ops`` (and the ``autograd.Function``s of ``rmsnorm``, ``rope``,
``flash_attention`` and ``ssd_scan``, forward and backward) send an
operand on the meta device here, as they send a CPU operand to the plain
version and a CUDA operand to the kernel: only the operand's device
chooses, and a CUDA tensor never comes here. Each function takes its
kernel wrapper's arguments, checks the shapes as the plain version does,
returns empty outputs of the kernel's shapes and dtypes (an in-place
kernel returns its operand), and reports the call and its work
(``kernels.work``) to the census that records (``work.record``), in
``LAUNCH_COUNTS``' unit: one a wrapper call, under the same conditions as
the wrapper counts (an empty write or gather launches nothing).

The float32 scratch a binding takes from the caching allocator
(``csrc/binding.cpp``) is made here too, for the length of the call, so
the census's peak of live bytes holds it as the card's allocator does.
Nothing here computes.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import work
from repro_torch.kernels.decode_attention import _dims as _decode_dims
from repro_torch.kernels.flash_attention import _dims as _flash_dims
from repro_torch.kernels.rope import _dims as _rope_dims
from repro_torch.kernels.ssd_scan import _check_bwd, _check_state
from repro_torch.kernels.ssd_scan import _dims as _scan_dims

F32 = torch.float32
# The card's streaming multiprocessors (NVIDIA H100 80GB HBM3), which size
# decode attention's split workspaces (``decode_split_len``)
H100_SMS = 132
_DECODE_HEAD_CHUNK, _DECODE_SPLIT_ALIGN = 8, 16      # csrc/model_ops.h
_RMSNORM_BWD_ROWS = 32                               # csrc/rmsnorm.cu


def _scratch(*shapes, like: torch.Tensor, dtype=F32) -> None:
    """The binding's scratch: made and dropped within the call."""
    for shape in shapes:
        like.new_empty(shape, dtype=dtype)


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.itemsize


# --------------------------------------------------------------------------- #
# replay kernels
# --------------------------------------------------------------------------- #

def ring_write_fields(datas: Sequence[torch.Tensor],
                      batches: Sequence[torch.Tensor], ptr, *,
                      capacity: Optional[int] = None, window_start=None):
    if len(datas) != len(batches):
        raise ValueError(f"ring_write of {len(batches)} batches into "
                         f"{len(datas)} fields")
    n = batches[0].shape[0]
    cap = datas[0].shape[0] if capacity is None else capacity
    for data, batch in zip(datas, batches):
        if batch.shape[0] > cap:
            raise ValueError(f"ring_write of {batch.shape[0]} rows into "
                             f"capacity {cap}")
        if batch.dtype != data.dtype:
            raise TypeError(f"batch has dtype {batch.dtype}, expected "
                            f"{data.dtype}")
        if batch.shape[1:] != data.shape[1:]:
            raise ValueError(f"batch rows {tuple(batch.shape[1:])} do not "
                             f"match data rows {tuple(data.shape[1:])}")
    if n:
        work.record("ring_write", work.ring_write(
            n, sum(_row_bytes(b) for b in batches)))
    return datas


def ring_write(data, batch, ptr, **kw):
    ring_write_fields([data], [batch], ptr, **kw)
    return data


def ring_gather_fields(datas: Sequence[torch.Tensor], idx: torch.Tensor, *,
                       window_start=None):
    if not 1 <= len(datas) <= 8:
        raise ValueError(f"ring_gather of {len(datas)} fields: takes 1 to 8")
    outs = [d.new_empty((idx.shape[0],) + d.shape[1:]) for d in datas]
    if idx.shape[0]:
        work.record("ring_gather", work.ring_gather(
            idx.shape[0], sum(_row_bytes(d) for d in datas)))
    return outs


def ring_gather(data, idx, **kw):
    return ring_gather_fields([data], idx, **kw)[0]


def per_scores(priorities, gumbel, alpha):
    if priorities.dim() != 1 or gumbel.shape != priorities.shape:
        raise ValueError(f"priorities {tuple(priorities.shape)} and gumbel "
                         f"{tuple(gumbel.shape)} must be one (rows,) shape")
    if priorities.shape[0]:
        work.record("per_scores", work.per_scores(priorities.shape[0]))
    return torch.empty_like(priorities)


def per_topk(priorities, gumbel, alpha, k, *, window_start=None):
    (rows,) = priorities.shape
    if not 0 <= k <= rows:
        raise ValueError(f"per_topk of k={k} from a {rows}-row window")
    scores = priorities.new_empty((k,))
    idx = priorities.new_empty((k,), dtype=torch.int32)
    if k:
        _scratch((k + rows,), like=priorities, dtype=torch.int64)
        work.record("per_topk", work.per_topk(rows, k))
    return scores, idx


def priority_scatter(priorities, idx, values, *, window_start=None):
    if idx.shape != values.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and values "
                         f"{tuple(values.shape)} differ")
    if idx.shape[0]:
        work.record("priority_scatter", work.priority_scatter(idx.shape[0]))
    return priorities


def ring_write_rowloop(data, batch, ptr):
    if batch.shape[0]:
        work.record("ring_write_rowloop",
                    work.ring_write(batch.shape[0], _row_bytes(batch)))
    return data


def ring_gather_rowloop(data, idx):
    if idx.shape[0]:
        work.record("ring_gather_rowloop",
                    work.ring_gather(idx.shape[0], _row_bytes(data)))
    return data.new_empty((idx.shape[0],) + data.shape[1:])


# --------------------------------------------------------------------------- #
# model kernels and their backward kernels
# --------------------------------------------------------------------------- #

def _rows(x: torch.Tensor, weight: torch.Tensor) -> int:
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match the "
                         f"last dimension of x {tuple(x.shape)}")
    return x.numel() // max(x.shape[-1], 1)


def rmsnorm(x, weight, *, eps: float = 1e-6):
    work.record("rmsnorm", work.rmsnorm(_rows(x, weight), x.shape[-1],
                                        x.dtype))
    return torch.empty_like(x)


def rmsnorm_bwd(x, weight, dy, *, eps: float = 1e-6):
    rows, dim = _rows(x, weight), x.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    dx, dw = torch.empty_like(x), weight.new_empty((dim,), dtype=F32)
    _scratch((-(-rows // _RMSNORM_BWD_ROWS), dim), like=x)
    work.record("rmsnorm_bwd", work.rmsnorm_bwd(rows, dim, x.dtype))
    return dx, dw


def _rope_work(name, q, k, pos_q, pos_k):
    _rope_dims(q, k, pos_q, pos_k)
    B, Sq, H, d = q.shape
    Sk, KV = (0, 0) if k is None else k.shape[1:3]
    work.record(name, work.rope(B, Sq, Sk, H, KV, d, q.dtype,
                                pos_q.itemsize))
    return torch.empty_like(q), None if k is None else torch.empty_like(k)


def rope(q, k, pos_q, pos_k, theta):
    return _rope_work("rope", q, k, pos_q, pos_k)


def rope_bwd(dq, dk, pos_q, pos_k, theta):
    return _rope_work("rope_bwd", dq, dk, pos_q, pos_k)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    prefix_len: Optional[int] = None,
                    return_lse: bool = False):
    B, Sq, H, d, Sk, KV = _flash_dims(q, k, v)
    out = torch.empty_like(q)
    lse = q.new_empty((B, H, Sq), dtype=F32) if return_lse else None
    work.record("flash_attention", work.flash_attention(
        B, Sq, Sk, H, KV, d, q.dtype, causal=causal, window=window,
        prefix_len=prefix_len, lse=return_lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        prefix_len: Optional[int] = None):
    B, Sq, H, d, Sk, KV = _flash_dims(q, k, v)
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _scratch((B, H, Sq), like=q)                            # rowsum
    work.record("flash_attention_bwd", work.flash_attention_bwd(
        B, Sq, Sk, H, KV, d, q.dtype, causal=causal, window=window,
        prefix_len=prefix_len))
    return grads


def _decode_splits(B: int, S: int, KV: int, G: int) -> int:
    """``decode_split_len``'s split count on the card's SMs."""
    blocks = B * KV * -(-G // _DECODE_HEAD_CHUNK)
    per_sm = 4 if G == 1 else 3
    splits = max(per_sm * H100_SMS // blocks, 1)
    length = -(-S // splits)
    length = -(-length // _DECODE_SPLIT_ALIGN) * _DECODE_SPLIT_ALIGN
    return -(-S // length)


def decode_attention(q, k_cache, v_cache, valid_len):
    B, H, d, S, KV = _decode_dims(q, k_cache, v_cache)
    out = torch.empty_like(q)
    splits = _decode_splits(B, S, KV, H // KV)
    _scratch((B, KV, splits, H // KV, d), (B, KV, splits, H // KV, 2),
             like=q)
    work.record("decode_attention",
                work.decode_attention(B, S, H, KV, d, q.dtype))
    return out


def ssd_scan(x, dtA, B_, C_, *, chunk: int = 64, initial_state=None,
             return_states: bool = False):
    Bb, S, H, P, N, L = _scan_dims(x, dtA, B_, C_, chunk)
    _check_state(initial_state, "initial_state", x, N)
    y, final = torch.empty_like(x), x.new_empty((Bb, H, P, N))
    states = x.new_empty((Bb, H, S // L, P, N), dtype=F32)
    _scratch((Bb, H, S), like=x)                            # acum
    work.record("ssd_scan", work.ssd_scan(
        Bb, S, H, P, N, L, x.dtype, initial_state=initial_state is not None,
        states=return_states))
    return (y, final, states) if return_states else (y, final)


def ssd_scan_bwd(x, dtA, B_, C_, states, dy, dfinal=None, *,
                 chunk: int = 64):
    L = _check_bwd(x, dtA, B_, C_, states, dy, dfinal, chunk)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    out = (torch.empty_like(x), torch.empty_like(dtA, dtype=F32),
           torch.empty_like(B_), torch.empty_like(C_),
           x.new_empty((Bb, H, P, N), dtype=F32))
    _scratch((Bb, H, S), (Bb, H, S // L, P, N), (3, Bb, H, S), like=x)
    work.record("ssd_scan_bwd", work.ssd_scan_bwd(Bb, S, H, P, N, L,
                                                  x.dtype))
    return out
