"""Device-resident replay ring buffer: the paper's shared memory.
Counterpart of the uniform half of ``repro/replay/buffer.py``.

The pool lives on the device; ``add_batch`` writes new rows into it with
one ring-write launch for all the fields and ``sample`` reads a batch
with one gather launch for all the fields (``kernels.ops`` chooses
kernel or plain version by the pool's device). Both work in place on
the ``ReplayState``'s tensors, the analogue of the JAX package's donated
ring. ``ptr`` and ``size`` are device int32 scalars; nothing here reads
them back to the host.

On a mesh (``rules``, from ``distributed.sharding.trainer_rules``) the
ring is placed (``core.model_parallel.place_replay``): each field is a
list of G contiguous shards on the batch groups' devices and the cursor
sits on the primary device. ``add_batch`` then launches one ring write a
group (every group receives the whole round and keeps its in-window
rows) and ``sample`` one gather a group, reduce-scattered so that group
g holds its B/G rows of the batch.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.analysis.hlolint.contract import EntrypointContract
from repro_torch.kernels import ops as kops

#: hlolint contract of the ring write: the pool is the paper's shared
#: memory, written in place (a rebuilt pool would copy the whole ring at
#: every add) with one ring-write launch
HLOLINT_CONTRACTS = (
    EntrypointContract(name="replay_add_batch", module=__name__,
                       inplace=True, state=("state",),
                       launches={"ring_write": "1"}),
)


class ReplayState(NamedTuple):
    data: Dict[str, torch.Tensor]  # each (capacity, ...) leaf (on a mesh,
                                   # a list of G (capacity / G, ...) shards)
    ptr: torch.Tensor              # int32 next write slot
    size: torch.Tensor             # int32 filled rows


def init_replay(capacity: int,
                specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                device="cuda") -> ReplayState:
    """specs: name -> (row_shape, dtype). E.g. {"obs": ((3,), f32), ...}."""
    dev = resolve_device(device)
    data = {k: torch.zeros((capacity,) + tuple(s), dtype=d, device=dev)
            for k, (s, d) in specs.items()}
    return ReplayState(data=data,
                       ptr=torch.zeros((), dtype=torch.int32, device=dev),
                       size=torch.zeros((), dtype=torch.int32, device=dev))


def specs_for_env(obs_dim: int, act_dim: int):
    f32 = torch.float32
    return {"obs": ((obs_dim,), f32), "act": ((act_dim,), f32),
            "rew": ((), f32), "next_obs": ((obs_dim,), f32),
            "done": ((), f32)}


def trainer_specs(obs_dim: int, act_dim: int):
    """The field set the trainer writes: env fields plus the ``"disc"``
    row (gamma^k(1-done), added by the n-step transform)."""
    specs = dict(specs_for_env(obs_dim, act_dim))
    specs["disc"] = ((), torch.float32)
    return specs


def write_plan(ptr, n: int, cap: int):
    """Ring slots for an n-row write: (ptr0, keep) — slot of the first
    surviving row and how many of the *newest* rows survive. A write
    larger than the capacity keeps only the newest ``capacity`` rows, so
    the result matches writing the rows one at a time."""
    drop = max(0, n - cap)
    return ((ptr + drop) % cap if drop else ptr), n - drop


def _capacity(state: ReplayState) -> int:
    first = next(iter(state.data.values()))
    if isinstance(first, list):
        return first[0].shape[0] * len(first)
    return first.shape[0]


# hlolint: entrypoint[replay_add_batch]
def add_batch(state: ReplayState, batch: Dict[str, torch.Tensor],
              extra: Sequence[Tuple[object, torch.Tensor]] = (), *,
              rules=None) -> ReplayState:
    """Write N new rows at (ptr + i) % capacity, in place: one ring-write
    launch for every field (one a group on a mesh), then ``ptr``/``size``
    advance on the device. ``extra`` holds more (pool, rows (N, ...))
    pairs written at the same slots in the same launch (the prioritized
    pool's priorities; on a mesh the pool is a list of shards)."""
    n = next(iter(batch.values())).shape[0]
    cap = _capacity(state)
    ptr0, keep = write_plan(state.ptr, n, cap)
    pairs = [(dest, batch[k]) for k, dest in state.data.items()]
    pairs += extra
    rows = [r[n - keep:] for _, r in pairs]
    # launched before ptr advances: ptr0 may alias it
    pools = [dest for dest, _ in pairs]
    if rules is None:
        kops.ring_write_fields(pools, rows, ptr0)
    else:
        kops.ring_write_fields_sharded(group_fields(pools), rows, ptr0,
                                       rules, capacity=cap)
    state.ptr.add_(n).remainder_(cap)
    state.size.add_(n).clamp_(max=cap)
    return state


def uniform_indices(state: ReplayState, batch_size: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(batch_size,) int32 draws, uniform over [0, max(size, 1)), made on
    the device without reading ``size`` back."""
    raw = torch.randint(0, 2 ** 31 - 1, (batch_size,), generator=generator,
                        device=state.size.device, dtype=torch.int32)
    return raw % torch.clamp(state.size, min=1)


def sample(state: ReplayState, idx: torch.Tensor, *, rules=None
           ) -> Dict[str, object]:
    """Gather the rows for the uniform draws ``idx`` (int32 in [0,
    max(size, 1)), e.g. from ``uniform_indices``), one gather launch for
    every field. Ring alignment: once the pool is full its oldest live
    row sits at ``ptr``. On a mesh each field comes back as a list of the
    G groups' (B/G, ...) rows, group g's on its device."""
    cap = _capacity(state)
    offset = torch.where(state.size >= cap, state.ptr,
                         torch.zeros_like(state.ptr))
    idx = torch.remainder(idx + offset, cap)
    if rules is None:
        rows = kops.ring_gather_fields(list(state.data.values()), idx)
        return dict(zip(state.data, rows))
    return by_field(list(state.data), kops.ring_gather_fields_sharded(
        group_fields(list(state.data.values())), idx, rules))


def group_fields(pools: List[List[torch.Tensor]]
                 ) -> List[List[torch.Tensor]]:
    """Field-major shards ``pools[f][g]`` -> group-major ``[g][f]``."""
    return [list(fields) for fields in zip(*pools)]


def by_field(names: Sequence[str], outs: List[List[torch.Tensor]]
             ) -> Dict[str, List[torch.Tensor]]:
    """Group-major gather outputs ``outs[g][f]`` -> ``{name: [rows of
    group g, ...]}``."""
    return {name: [out[f] for out in outs] for f, name in enumerate(names)}
