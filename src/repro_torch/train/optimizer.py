"""Adam in PyTorch, updating parameters and moments in place.

Counterpart of ``repro/train/optimizer.py``'s ``make_optimizer("adam")``
(no clipping, constant learning rate: what the RL algorithms use). The
state keeps the JAX layout ``OptState(step, mu, nu)``, with ``mu``/``nu``
trees shaped like the parameters and an int32 ``step``, so a state
carries across one to one (``repro_torch.interop``). The bias correction
is computed in float32 from the device step counter, as in the JAX
package. ``update`` writes the new parameters and moments into the
existing tensors: the port's analogue of buffer donation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor       # scalar int32
    mu: object               # first moment, shaped like the params
    nu: object               # second moment


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable         # (grads, state, params) -> (params, state)


def make_optimizer(name: str, learning_rate: float, *, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    if name != "adam":
        raise ValueError(f"unknown optimizer {name!r} (the port has adam)")

    def init(params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, mu=zeros, nu=tree_map(torch.zeros_like,
                                                         zeros))

    @torch.no_grad()
    def update(grads, state: OptState, params):
        """One Adam step; ``grads`` is a list of tensors in the order of
        ``tree_leaves(params)``. Mutates ``params`` and ``state``."""
        state.step.add_(1)
        sf = state.step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        for p, g, m, v in zip(tree_leaves(params), grads,
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p.sub_(learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
        return params, state

    return Optimizer(init=init, update=update)
