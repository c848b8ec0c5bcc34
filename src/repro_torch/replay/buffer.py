"""Device-resident replay ring buffer: the paper's shared memory.
Counterpart of the uniform half of ``repro/replay/buffer.py``.

The pool lives on the device; ``add_batch`` writes new rows into it with
one ring-write launch for all the fields and ``sample`` reads a batch
with one gather launch for all the fields (``kernels.ops`` chooses
kernel or plain version by the pool's device). Both work in place on
the ``ReplayState``'s tensors, the analogue of the JAX package's donated
ring. ``ptr`` and ``size`` are device int32 scalars; nothing here reads
them back to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops


class ReplayState(NamedTuple):
    data: Dict[str, torch.Tensor]  # each (capacity, ...) leaf
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


def add_batch(state: ReplayState, batch: Dict[str, torch.Tensor],
              extra: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()
              ) -> ReplayState:
    """Write N new rows at (ptr + i) % capacity, in place: one ring-write
    launch for every field, then ``ptr``/``size`` advance on the device.
    ``extra`` holds more (pool (capacity, ...), rows (N, ...)) pairs
    written at the same slots in the same launch (the prioritized pool's
    priorities)."""
    n = next(iter(batch.values())).shape[0]
    cap = next(iter(state.data.values())).shape[0]
    ptr0, keep = write_plan(state.ptr, n, cap)
    pairs = [(dest, batch[k]) for k, dest in state.data.items()]
    pairs += extra
    # launched before ptr advances: ptr0 may alias it
    kops.ring_write_fields([dest for dest, _ in pairs],
                           [rows[n - keep:] for _, rows in pairs], ptr0)
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


def sample(state: ReplayState, idx: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Gather the rows for the uniform draws ``idx`` (int32 in [0,
    max(size, 1)), e.g. from ``uniform_indices``), one gather launch for
    every field. Ring alignment: once the pool is full its oldest live
    row sits at ``ptr``."""
    cap = next(iter(state.data.values())).shape[0]
    offset = torch.where(state.size >= cap, state.ptr,
                         torch.zeros_like(state.ptr))
    idx = torch.remainder(idx + offset, cap)
    rows = kops.ring_gather_fields(list(state.data.values()), idx)
    return dict(zip(state.data, rows))
