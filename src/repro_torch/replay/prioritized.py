"""Prioritized experience replay (Schaul et al. 2016), device-resident.
Counterpart of ``repro/replay/prioritized.py`` on a single device.

Priorities live on the device next to the ring's rows, and a batch is
drawn with the Gumbel-top-k trick: the k best of ``alpha * log p_i +
G_i`` are k draws without replacement proportional to ``p_i^alpha``, in
one pass with no sum-tree and no host round trip. The ``per_topk``
kernel scores and selects in one call; the Gumbel field ``G`` comes in
as a tensor (``SpreezeTrainer``'s draw source makes it), so a test can
hand the port the very field the JAX package draws.

Unwritten rows carry priority 0 and score a true ``-inf``, so they are
never drawn. Draws beyond the live-row count cycle through the live
draws, and importance weights normalise over the written rows only.

Everything works in place on the ``PrioritizedState``'s tensors, and
nothing here reads a tensor back to the host: ``n_live`` and
``max_priority`` stay on the device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.replay import buffer as rb


class PrioritizedState(NamedTuple):
    base: rb.ReplayState
    priorities: torch.Tensor     # (capacity,) f32, 0 for unwritten rows
    max_priority: torch.Tensor   # f32 scalar: new rows enter at it


def init_prioritized(capacity: int, specs, device="cuda"
                     ) -> PrioritizedState:
    dev = resolve_device(device)
    return PrioritizedState(
        base=rb.init_replay(capacity, specs, dev),
        priorities=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        max_priority=torch.ones((), dtype=torch.float32, device=dev))


def add_batch(state: PrioritizedState, batch: Dict[str, torch.Tensor]
              ) -> PrioritizedState:
    """Write the rows into the ring and give their slots the current max
    priority (so every new row gets drawn), in place: the ``ring_write``
    kernel on the ``(capacity, 1)`` priority vector, on the same slots as
    the data, oversized-write drop included."""
    n = next(iter(batch.values())).shape[0]
    cap = state.priorities.shape[0]
    ptr0, keep = rb.write_plan(state.base.ptr, n, cap)
    # launched before the data write advances ptr, which ptr0 may alias;
    # the kernel takes only contiguous rows
    kops.ring_write(state.priorities.view(cap, 1),
                    state.max_priority.expand(keep, 1).contiguous(), ptr0)
    rb.add_batch(state.base, batch)
    return state


def sample(state: PrioritizedState, gumbel: torch.Tensor, batch_size: int,
           *, alpha: float = 0.6, beta: float = 0.4
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """-> (batch, indices (batch_size,) int32, importance weights
    normalised to max 1), for the Gumbel field ``gumbel`` (capacity,).

    The pool must hold at least one written row (warmup makes sure)."""
    pri = state.priorities
    idx = kops.per_topk(pri, gumbel, alpha, batch_size)[1]
    # every live row outranks every -inf slot, so draws past the live
    # count are not rows: wrap them onto the live draws
    live = pri > 0.0
    n_live = torch.clamp(live.sum(dtype=torch.int32), min=1)
    pos = torch.remainder(
        torch.arange(batch_size, dtype=torch.int32, device=pri.device),
        n_live)
    idx = idx.index_select(0, pos)
    batch = {k: kops.ring_gather(v, idx) for k, v in state.base.data.items()}

    # w_i = (N * P(i))^-beta over the written rows, normalised by the max;
    # the drawn rows' priority mass comes through the same gather
    p = torch.where(live, torch.clamp(pri, min=1e-12) ** alpha, 0.0)
    z = torch.clamp(p.sum(), min=1e-12)
    p_sel = kops.ring_gather(p.view(-1, 1), idx)[:, 0]
    w = (n_live.to(torch.float32) * (p_sel / z)) ** (-beta)
    w = w / torch.clamp(w.max(), min=1e-12)
    return batch, idx, w


def update_priorities(state: PrioritizedState, idx: torch.Tensor,
                      td_errors: torch.Tensor, eps: float = 1e-3
                      ) -> PrioritizedState:
    """Set the drawn rows' priorities to ``|TD error| + eps`` (PER eq. 1)
    with the ``priority_scatter`` kernel (the last draw of a repeated row
    wins) and raise ``max_priority``, in place on the device."""
    pri_new = torch.abs(td_errors) + eps
    kops.priority_scatter(state.priorities, idx, pri_new)
    state.max_priority.copy_(torch.maximum(state.max_priority,
                                           pri_new.max()))
    return state
