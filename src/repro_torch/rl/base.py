"""Shared RL-algorithm plumbing: state container, target updates,
registry. Counterpart of ``repro/rl/base.py``.

Every algorithm exposes::

  init_state(generator, obs_dim, act_dim, hp, device) -> AlgoState
  make_update_step(hp, obs_dim, act_dim)
      -> update(state, batch, eps_next, eps_actor)
  make_act(hp, deterministic) -> act(actor_params, obs, eps)

``batch`` is the replay sample dict {obs, act, rew, next_obs, done,
disc}. Where the JAX update draws noise from a key, the port takes the
draws as tensors. The update mutates the state's tensors in place (the
analogue of jit + donation) and returns the same state object.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves
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
    q: Any                 # stacked ensemble: every leaf has a leading (2,)
    q_target: Any
    log_alpha: torch.Tensor  # scalar (unused by TD3/DDPG)
    opt_actor: Any
    opt_q: Any
    opt_alpha: Any
    step: torch.Tensor


@torch.no_grad()
def polyak(target, online, tau: float):
    """target <- (1 - tau) * target + tau * online, in place."""
    for t, o in zip(tree_leaves(target), tree_leaves(online)):
        t.mul_(1 - tau).add_(tau * o)
    return target


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
        from repro_torch.rl import sac  # noqa: F401  (registers)
    if name not in _ALGOS:
        raise KeyError(f"unknown algo {name!r}; known: {sorted(_ALGOS)}")
    return _ALGOS[name]
