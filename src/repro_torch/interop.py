"""Carrying state between the JAX package and the port, through numpy.

The JAX package's ``AlgoState``, ``ReplayState``, ``PrioritizedState``
and env states arrive as nested dicts and tuples (NamedTuples included)
of numpy arrays, for example ``jax.tree.map(np.asarray, state)``; this
module turns them into the port's tensors and back (env states, plain
dicts of arrays, go through ``to_tensors`` / ``to_numpy`` as they are).
The LM stack's parameters and KV caches (``factory.init_params``,
``factory.prefill``) are nested dicts of stacked ``(L, ...)`` leaves on
both sides and go through ``to_tensors`` / ``to_numpy`` as they are.
The port keeps the JAX weight layout (``(in, out)`` matrices, the
ensemble and the layers stacked on a leading axis), so every leaf maps
one to one and no transpose is needed. Leaves keep their dtype, bfloat16
included (numpy's bfloat16 is ``ml_dtypes``', the type JAX hands out), so
a round trip is bitwise. This module imports neither JAX nor
the JAX package: it only relies on the field order both sides share.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.replay.buffer import ReplayState
from repro_torch.replay.prioritized import PrioritizedState
from repro_torch.rl.base import AlgoState
from repro_torch.train.optimizer import OptState


def to_tensors(tree, device) -> Any:
    """Nested mappings/tuples of arrays -> dicts/tuples of tensors."""
    if isinstance(tree, Mapping):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_tensors(v, device) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":      # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(tree) -> Any:
    """Dicts/tuples of tensors -> the same nesting of numpy arrays.
    bfloat16 leaves need ``ml_dtypes``' numpy type to be registered (it is
    wherever JAX is imported)."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()



def _fields(obj, names) -> Dict[str, Any]:
    """A NamedTuple, mapping or plain tuple in ``names`` order -> dict."""
    if isinstance(obj, Mapping):
        return {n: obj[n] for n in names}
    if hasattr(obj, "_asdict"):
        return {n: obj._asdict()[n] for n in names}
    if len(obj) != len(names):
        raise ValueError(f"expected {len(names)} fields {names}, got "
                         f"{len(obj)}")
    return dict(zip(names, obj))


def _opt_state(obj, device) -> OptState:
    return OptState(**{k: to_tensors(v, device)
                       for k, v in _fields(obj, OptState._fields).items()})


def algo_state_from_numpy(state, device) -> AlgoState:
    """An ``opt_alpha`` of ``None`` (TD3, DDPG) stays ``None``."""
    f = _fields(state, AlgoState._fields)
    opts = ("opt_actor", "opt_q", "opt_alpha")
    return AlgoState(**{k: (None if v is None else
                            _opt_state(v, device) if k in opts
                            else to_tensors(v, device))
                        for k, v in f.items()})


def algo_state_to_numpy(state: AlgoState) -> Dict[str, Any]:
    """-> dict of the ``AlgoState`` fields; optimizer states as
    ``{"step", "mu", "nu"}`` dicts, a ``None`` one as ``None``."""
    out = {}
    for k, v in state._asdict().items():
        out[k] = (None if v is None else
                  {n: to_numpy(x) for n, x in v._asdict().items()}
                  if isinstance(v, OptState) else to_numpy(v))
    return out


def replay_from_numpy(replay, device) -> ReplayState:
    f = _fields(replay, ReplayState._fields)
    return ReplayState(data=to_tensors(f["data"], device),
                       ptr=to_tensors(f["ptr"], device),
                       size=to_tensors(f["size"], device))


def replay_to_numpy(replay: ReplayState) -> Dict[str, Any]:
    return {"data": to_numpy(replay.data), "ptr": to_numpy(replay.ptr),
            "size": to_numpy(replay.size)}


def prioritized_from_numpy(state, device) -> PrioritizedState:
    f = _fields(state, PrioritizedState._fields)
    return PrioritizedState(base=replay_from_numpy(f["base"], device),
                            priorities=to_tensors(f["priorities"], device),
                            max_priority=to_tensors(f["max_priority"],
                                                    device))


def prioritized_to_numpy(state: PrioritizedState) -> Dict[str, Any]:
    """-> ``{"base": replay dict, "priorities", "max_priority"}``."""
    return {"base": replay_to_numpy(state.base),
            "priorities": to_numpy(state.priorities),
            "max_priority": to_numpy(state.max_priority)}
