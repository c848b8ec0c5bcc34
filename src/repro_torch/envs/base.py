"""Batched continuous-control environments in PyTorch.

Counterpart of ``repro/envs/base.py``. Where the JAX envs are written for
one instance and ``vmap``-ed, these are batched natively: a state is a
dict of (num_envs,) tensors. Randomness is injected: ``reset`` takes the
draws it needs as tensors (``reset_draws`` makes them from a
``torch.Generator``), so a caller can hand in exactly the numbers another
implementation drew.

API:
  env.reset(draws)                      -> state
  env.step(state, action)               -> (state', obs, reward, done)
  env.observe(state)                    -> obs
  env.autoreset_step(state, action, draws)
Actions are in [-1, 1]^act_dim; envs rescale internally.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    act_dim: int
    episode_len: int
    # difficulty ladder position (paper: Pendulum < Walker < Ant < Humanoid)
    difficulty: int = 0


class Env:
    spec: EnvSpec

    def reset_draws(self, n: int, generator: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        """The random numbers ``reset`` consumes for ``n`` envs, drawn on
        the generator's device."""
        raise NotImplementedError

    def reset(self, draws: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def step(self, state, action) -> Tuple[Dict, torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        raise NotImplementedError

    def observe(self, state) -> torch.Tensor:
        raise NotImplementedError

    def reset_batch(self, n: int, generator: torch.Generator):
        return self.reset(self.reset_draws(n, generator))

    def autoreset_step(self, state, action, draws):
        """Step that resets each env whose episode ended, from ``draws``.
        Returns (state', obs', reward, done); for a done env ``obs'`` is
        the observation of the fresh state, as in the JAX package."""
        nstate, _, rew, done = self.step(state, action)
        fresh = self.reset(draws)
        nstate = {k: torch.where(done, fresh[k], v)
                  for k, v in nstate.items()}
        return nstate, self.observe(nstate), rew, done


_REGISTRY: Dict[str, Callable[[], Env]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def make(name: str) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def env_names():
    return sorted(_REGISTRY)
