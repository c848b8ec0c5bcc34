"""Pendulum-v0 with exact gym dynamics (the paper's 'simple' benchmark),
batched over the leading env axis. Counterpart of
``repro/envs/pendulum.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.envs.base import Env, EnvSpec, register


def _angle_normalize(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


@register("pendulum")
class Pendulum(Env):
    """Classic torque-limited pendulum swing-up (gym Pendulum-v0).

    obs = (cos θ, sin θ, θ̇); reward = -(θ² + 0.1 θ̇² + 0.001 u²);
    episode = 200 steps; solved ≈ return > -200 (paper Table 1 target)."""

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def __init__(self):
        self.spec = EnvSpec("pendulum", obs_dim=3, act_dim=1,
                            episode_len=200, difficulty=0)

    def reset_draws(self, n, generator):
        dev = generator.device
        u = torch.rand((2, n), generator=generator, device=dev)
        return {"th": (2 * u[0] - 1) * math.pi, "thdot": 2 * u[1] - 1}

    def reset(self, draws):
        """``draws``: th ~ U[-π, π), thdot ~ U[-1, 1), each (n,)."""
        th = draws["th"]
        return {"th": th, "thdot": draws["thdot"],
                "t": torch.zeros(th.shape, dtype=torch.int32,
                                 device=th.device)}

    def observe(self, state):
        th = state["th"]
        return torch.stack([torch.cos(th), torch.sin(th), state["thdot"]],
                           dim=-1)

    def step(self, state, action):
        th, thdot = state["th"], state["thdot"]
        u = torch.clamp(action[..., 0], -1.0, 1.0) * self.max_torque
        cost = (_angle_normalize(th) ** 2 + 0.1 * thdot ** 2
                + 0.001 * u ** 2)
        newthdot = thdot + (3 * self.g / (2 * self.length) * torch.sin(th)
                            + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        t = state["t"] + 1
        state = {"th": newth, "thdot": newthdot, "t": t}
        done = t >= self.spec.episode_len
        return state, self.observe(state), -cost, done
