"""Optimizers in PyTorch, updating parameters and moments in place.

Counterpart of ``repro/train/optimizer.py``: ``adam`` / ``adamw`` /
``sgd`` (with momentum), global-norm clipping and a linear-warmup /
cosine-decay schedule. The state keeps the JAX layout ``OptState(step,
mu, nu)``, with ``mu``/``nu`` trees shaped like the parameters (``nu``
scalar zeros a leaf under sgd, as the reference) and an int32 ``step``,
so a state carries across one to one (``repro_torch.interop``). The step
count, the bias corrections, a scheduled learning rate and the clip
scale are device tensors computed in float32 as in the JAX package:
nothing is read back to the host. A constant learning rate stays a
Python float (the same float32 product as a device scalar's, with no
launch), so the RL algorithms' ``adam`` keeps its ops and its bits.
``update`` writes the new parameters and moments into the existing
tensors: the port's analogue of buffer donation. Parameters may sit on
several devices (a Q ensemble placed over a mesh's ac rows): the bias
corrections, two scalars, reach each device once a step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import to_group

OPTIMIZERS = ("adam", "adamw", "sgd")


class OptState(NamedTuple):
    step: torch.Tensor       # scalar int32
    mu: object               # first moment (or momentum), like the params
    nu: object               # second moment; scalar zeros a leaf for sgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable         # (grads, state, params) -> (params, state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-9)), in float32,
    the norm): the reference's formula, not ``clip_grad_norm_``'s."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def make_schedule(base_lr: float, warmup_steps: int = 0,
                  decay_steps: Optional[int] = None) -> Callable:
    """step (a device int tensor) -> the learning rate, a float32 device
    scalar: linear warmup over ``warmup_steps``, then cosine decay to 0
    at ``decay_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        rate = torch.full_like(step, base_lr)
        if warmup_steps:
            rate = rate * torch.clamp((step + 1) / warmup_steps, max=1.0)
        if decay_steps:
            frac = torch.clamp((step - warmup_steps)
                               / max(1, decay_steps - warmup_steps), 0.0, 1.0)
            rate = rate * 0.5 * (1 + torch.cos(math.pi * frac))
        return rate
    return lr


def make_optimizer(name: str, learning_rate: float, *,
                   weight_decay: float = 0.0, grad_clip: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   momentum: float = 0.9, warmup_steps: int = 0,
                   decay_steps: Optional[int] = None) -> Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: {OPTIMIZERS}")
    sched = make_schedule(learning_rate, warmup_steps, decay_steps) \
        if warmup_steps or decay_steps else None
    adam = name in ("adam", "adamw")

    def init(params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        nu = tree_map(torch.zeros_like, zeros) if adam else tree_map(
            lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
            params)
        return OptState(step=step, mu=zeros, nu=nu)

    def write(p: torch.Tensor, delta: torch.Tensor) -> None:
        """p -= delta, in float32, cast back to p's dtype."""
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        """One step; ``grads`` is a list of tensors in the order of
        ``tree_leaves(params)``. Mutates ``params`` and ``state``."""
        if grad_clip:
            grads, _ = clip_by_global_norm(list(grads), grad_clip)
        else:
            grads = [g.float() for g in grads]
        state.step.add_(1)
        lr = learning_rate if sched is None else sched(state.step)
        leaves = zip(tree_leaves(params), grads, tree_leaves(state.mu),
                     tree_leaves(state.nu))
        if not adam:                                       # sgd
            for p, g, m, _ in leaves:
                m.mul_(momentum).add_(g)
                write(p, lr * m)
            return params, state
        sf = state.step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        on = {bc1.device: (bc1, bc2, lr)}
        for p, g, m, v in leaves:
            if p.device not in on:
                # a placed ensemble's towers on other devices of the mesh
                on[p.device] = to_group((bc1, bc2), p.device) + (
                    lr if sched is None else to_group(lr, p.device),)
            bc1, bc2, lr = on[p.device]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if name == "adamw" and weight_decay:
                u = u + weight_decay * p.float()
            write(p, lr * u)
        return params, state

    return Optimizer(init=init, update=update)
