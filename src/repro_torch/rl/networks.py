"""Actor / critic MLP towers. Counterpart of the MLP half of
``repro/rl/networks.py``.

Weights keep the JAX layout: ``{"l<i>": {"w": (in, out), "b": (out,)}}``
with ``x @ w + b``. The double-Q ensemble stacks its two towers on a
leading axis (``w`` is (2, in, out), ``b`` is (2, out)) and evaluates
both with one batched ``torch.matmul``, where the JAX package uses
``vmap``. The actor's Gaussian noise is an argument (``eps``), never
drawn here.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def dense_init(generator: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1/fan_in) weights, fan-in on the second-to-last axis."""
    return (torch.randn(shape, generator=generator, device=device)
            / math.sqrt(shape[-2]))


def init_mlp_tower(generator, in_dim: int, out_dim: int,
                   hidden: Sequence[int] = (256, 256), *, n=None,
                   device="cuda"):
    """An MLP tower; with ``n`` a stack of ``n`` towers on a leading axis."""
    dims = (in_dim,) + tuple(hidden) + (out_dim,)
    lead = () if n is None else (n,)
    return {f"l{i}": {"w": dense_init(generator,
                                      lead + (dims[i], dims[i + 1]), device),
                      "b": torch.zeros(lead + (dims[i + 1],), device=device)}
            for i in range(len(dims) - 1)}


def mlp_tower(p, x):
    """x (..., in) -> (..., out); a stacked tower maps (B, in) to
    (n, B, out) by broadcasting over its leading axis."""
    n = len(p)
    for i in range(n):
        w, b = p[f"l{i}"]["w"], p[f"l{i}"]["b"]
        x = torch.matmul(x, w) + b.unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# policy (actor)
# ---------------------------------------------------------------------------

def init_policy(generator, obs_dim: int, act_dim: int,
                hidden: Sequence[int] = (256, 256), device="cuda"):
    """Gaussian policy: outputs (mean, log_std) -> tanh squashed."""
    return init_mlp_tower(generator, obs_dim, 2 * act_dim, hidden,
                          device=device)


def policy_dist(p, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, log_std = mlp_tower(p, obs).chunk(2, dim=-1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(p, obs, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-Gaussian sample with the standard-normal draw
    ``eps`` (shaped like the action) -> (action in [-1,1], log_prob)."""
    mean, log_std = policy_dist(p, obs)
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = (-0.5 * (eps ** 2) - log_std - _HALF_LOG_2PI).sum(-1)
    # tanh change of variables
    logp = logp - torch.log(torch.clamp(1 - act ** 2, min=1e-6)).sum(-1)
    return act, logp


def deterministic_action(p, obs) -> torch.Tensor:
    mean, _ = policy_dist(p, obs)
    return torch.tanh(mean)


def det_actor_action(p, obs) -> torch.Tensor:
    """The deterministic actor of TD3 and DDPG (an ``init_mlp_tower`` of
    width act_dim): ``tanh(mlp(obs))``."""
    return torch.tanh(mlp_tower(p, obs))


# ---------------------------------------------------------------------------
# double-Q ensemble
# ---------------------------------------------------------------------------

def init_ensemble_q(generator, obs_dim: int, act_dim: int, n: int = 2,
                    hidden: Sequence[int] = (256, 256), device="cuda"):
    """``n`` Q towers stacked on a leading axis."""
    return init_mlp_tower(generator, obs_dim + act_dim, 1, hidden, n=n,
                          device=device)


def ensemble_q_values(stacked, obs, act) -> torch.Tensor:
    """-> (n, B) Q values of every ensemble member."""
    return mlp_tower(stacked, torch.cat([obs, act], dim=-1))[..., 0]


def min_q(stacked, obs, act) -> torch.Tensor:
    """Elementwise min over the ensemble -> (B,)."""
    return ensemble_q_values(stacked, obs, act).min(dim=0).values
