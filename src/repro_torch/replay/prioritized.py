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

On a mesh (``rules``) the priorities are a list of G shards beside the
ring's (``core.model_parallel.place_replay``): the selection is the
two-phase ``per_topk_sharded`` over the one Gumbel field, ``n_live`` and
the importance weights' normaliser sum the shards' counts and masses on
the primary device, and the re-prioritisation is group-local.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import sum_on, to_group
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


def add_batch(state: PrioritizedState, batch: Dict[str, torch.Tensor], *,
              rules=None) -> PrioritizedState:
    """Write the rows into the ring and give their slots the current max
    priority (so every new row gets drawn), in place: the priorities'
    ``(capacity, 1)`` view (a shard's ``(rows, 1)`` view on a mesh) is
    one more field of the data's ring-write launch, on the same slots,
    oversized-write drop included."""
    n = next(iter(batch.values())).shape[0]
    # the kernel takes only contiguous rows
    rows = state.max_priority.expand(n, 1).contiguous()
    pri = state.priorities
    pool = (pri.view(-1, 1) if rules is None
            else [p.view(-1, 1) for p in pri])
    rb.add_batch(state.base, batch, extra=[(pool, rows)], rules=rules)
    return state


def sample(state: PrioritizedState, gumbel: torch.Tensor, batch_size: int,
           *, alpha: float = 0.6, beta: float = 0.4, rules=None
           ) -> Tuple[Dict[str, object], torch.Tensor, object]:
    """-> (batch, indices (batch_size,) int32, importance weights
    normalised to max 1), for the Gumbel field ``gumbel`` (capacity,).
    On a mesh the batch's fields and the weights are lists of the G
    groups' rows, the indices whole on the primary device.

    The pool must hold at least one written row (warmup makes sure)."""
    pri = state.priorities
    sharded = rules is not None
    home = gumbel.device
    idx = (kops.per_topk_sharded(pri, gumbel, alpha, batch_size, rules)
           if sharded else kops.per_topk(pri, gumbel, alpha, batch_size))[1]
    shards = pri if sharded else [pri]
    # every live row outranks every -inf slot, so draws past the live
    # count are not rows: wrap them onto the live draws
    n_live = torch.clamp(sum_on([(p > 0.0).sum(dtype=torch.int32)
                                  for p in shards], home), min=1)
    pos = torch.remainder(
        torch.arange(batch_size, dtype=torch.int32, device=home), n_live)
    idx = idx.index_select(0, pos)

    # w_i = (N * P(i))^-beta over the written rows, normalised by the max;
    # the drawn rows' priority mass is one more field of the batch's
    # gather launch
    p = [torch.where(s > 0.0, torch.clamp(s, min=1e-12) ** alpha, 0.0)
         for s in shards]
    z = torch.clamp(sum_on([s.sum() for s in p], home), min=1e-12)
    data = state.base.data
    if sharded:
        outs = kops.ring_gather_fields_sharded(
            [fields + [p_g] for fields, p_g in zip(
                rb.group_fields(list(data.values())), p)], idx, rules)
    else:
        outs = [kops.ring_gather_fields(list(data.values()) + p, idx)]
    w = [(to_group(n_live, out[-1].device).to(torch.float32)
          * (out[-1] / to_group(z, out[-1].device))) ** (-beta)
         for out in outs]
    w_max = torch.clamp(torch.stack([to_group(x.max(), home) for x in w])
                        .max(), min=1e-12)
    w = [x / to_group(w_max, x.device) for x in w]
    if not sharded:
        return dict(zip(data, outs[0][:-1])), idx, w[0]
    return rb.by_field(list(data), [out[:-1] for out in outs]), idx, w


# hlolint: exempt -- runs inside megastep_per and megastep_sharded_per, whose contracts hold its scatter
def update_priorities(state: PrioritizedState, idx: torch.Tensor,
                      td_errors: torch.Tensor, eps: float = 1e-3, *,
                      rules=None) -> PrioritizedState:
    """Set the drawn rows' priorities to ``|TD error| + eps`` (PER eq. 1)
    with the ``priority_scatter`` kernel (the last draw of a repeated row
    wins; one launch a group on a mesh) and raise ``max_priority``, in
    place on the device."""
    pri_new = torch.abs(td_errors) + eps
    if rules is None:
        kops.priority_scatter(state.priorities, idx, pri_new)
    else:
        kops.priority_scatter_sharded(state.priorities, idx, pri_new, rules)
    state.max_priority.copy_(torch.maximum(state.max_priority,
                                           pri_new.max()))
    return state
