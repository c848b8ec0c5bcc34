"""Shared RL-algorithm plumbing: state container, target updates,
registry. Counterpart of ``repro/rl/base.py``.

Every algorithm module exposes::

  UPDATE_NOISES: int   # standard-normal (B, act_dim) draws an update takes
  init_state(generator, obs_dim, act_dim, hp, device) -> AlgoState
  make_update_step(hp, obs_dim, act_dim)
      -> UpdateStep: update(state, batch, *noises)  # UPDATE_NOISES of them
  make_act(hp, deterministic) -> act(actor_params, obs, eps)

``batch`` is the replay sample dict {obs, act, rew, next_obs, done,
disc}. Where the JAX update draws noise from a key, the port takes the
draws as tensors: SAC two (the critic target's next action, the actor
loss's action), TD3 one (the target-policy smoothing noise), DDPG none.
The update mutates the state's tensors in place (the analogue of jit +
donation) and returns the same state object.

**Replicas.** An algorithm writes its update once, as a generator
(``UpdateStep.steps``) over one replica's share of the batch: each mean
over the batch is ``batch_mean(x, scale)`` (``scale`` is the share's
fraction of the whole batch, 1 on one device), and at each point where
the replicas must agree it yields a list of tensors (gradients, and the
batch statistics an optimizer step reads) and takes back their sums
over the replicas. ``UpdateStep.__call__`` runs it on one device, where
each sum is the value itself; ``drive_replicas`` runs one generator a
replica in lock step, computes each sum once and hands every replica
the same tensor, so the replicas' Adam steps stay bitwise equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Generator, List, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import sum_on, to_group
from repro_torch.train.optimizer import Optimizer, make_optimizer


@dataclass(frozen=True)
class AlgoHP:
    """Hyperparameters shared by SAC/TD3/DDPG (paper defaults)."""
    algo: str = "sac"
    gamma: float = 0.99
    tau: float = 0.005                 # polyak target rate
    lr: float = 3e-4
    hidden: Tuple[int, ...] = (256, 256)
    # SAC
    init_alpha: float = 0.2
    autotune_alpha: bool = True
    target_entropy_scale: float = 1.0  # target_entropy = -scale * act_dim
    # TD3
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    explore_noise: float = 0.1         # TD3/DDPG exploration


class AlgoState(NamedTuple):
    actor: Any
    q: Any                 # a stack of n Q towers: every leaf has a leading
                           # (n,), n = 2 (SAC, TD3) or 1 (DDPG)
    q_target: Any          # the target Q stack (SAC), or {"q", "actor"}
                           # (TD3, DDPG: the target actor too)
    log_alpha: torch.Tensor  # scalar (unused by TD3/DDPG)
    opt_actor: Any
    opt_q: Any
    opt_alpha: Any         # None for TD3/DDPG
    step: torch.Tensor


@torch.no_grad()
def polyak(target, online, tau: float):
    """target <- (1 - tau) * target + tau * online, in place."""
    for t, o in zip(tree_leaves(target), tree_leaves(online)):
        t.mul_(1 - tau).add_(tau * o)
    return target


def leaf_grads(loss: torch.Tensor, tree):
    """d loss / d each leaf of ``tree``, in ``tree_leaves`` order."""
    return torch.autograd.grad(loss, tree_leaves(tree))


def with_grad(tree):
    """Leaves that autograd tracks, sharing storage with ``tree``."""
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def batch_mean(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The mean of ``x`` as a replica's share of the whole batch's mean:
    ``mean(x) * scale``, exactly ``torch.mean(x)`` at scale 1."""
    m = torch.mean(x)
    return m if scale == 1.0 else m * scale


def drive(steps: Generator) -> Any:
    """Runs one update generator on one device: each list it yields comes
    back as it is (a sum over one replica), and its return value is the
    update's."""
    try:
        sums = next(steps)
        while True:
            sums = steps.send(sums)
    except StopIteration as stop:
        return stop.value


def _sum_over_replicas(requests: List[List[torch.Tensor]]
                       ) -> List[List[torch.Tensor]]:
    """Each yielded tensor summed over the replicas in replica order, once,
    on replica 0's copy's device, then moved to each replica's copy's
    device (within an ac row only: a replica's tower grads and their sum
    stay on that row). Out of place, so no replica's own tensor changes."""
    totals = [sum_on(ts, ts[0]) for ts in zip(*requests)]
    return [[to_group(t, own) for t, own in zip(totals, req)]
            for req in requests]


def drive_replicas(gens: List[Generator]) -> List[Any]:
    """Runs one update generator a replica in lock step: at every yield
    each replica gets the sums over all replicas (``_sum_over_replicas``);
    returns the replicas' return values."""
    requests = [next(g) for g in gens]
    while True:
        sums = _sum_over_replicas(requests)
        requests, results = [], []
        for g, s in zip(gens, sums):
            try:
                requests.append(g.send(s))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if requests:
                raise RuntimeError("the replicas of one update went out of "
                                   "step")
            return results


class UpdateStep:
    """An algorithm's update: callable on one device, and ``steps``, the
    generator ``steps(state, batch, *noises, scale=1.0)`` that a mesh
    drives once a replica."""

    def __init__(self, steps: Callable[..., Generator]):
        self.steps = steps

    def __call__(self, state, batch, *noises):
        return drive(self.steps(state, batch, *noises))


def make_opts(hp: AlgoHP) -> Tuple[Optimizer, Optimizer, Optimizer]:
    mk = lambda: make_optimizer("adam", hp.lr)
    return mk(), mk(), mk()


_ALGOS: Dict[str, Any] = {}


def register_algo(name: str):
    def deco(mod):
        _ALGOS[name] = mod
        return mod
    return deco


def get_algo(name: str):
    if name not in _ALGOS:
        from repro_torch.rl import ddpg, sac, td3  # noqa: F401  (register)
    if name not in _ALGOS:
        raise KeyError(f"unknown algo {name!r}; known: {sorted(_ALGOS)}")
    return _ALGOS[name]
