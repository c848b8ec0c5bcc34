"""CartPole swing-up (continuous force), batched over the leading env
axis. Counterpart of ``repro/envs/cartpole.py``.

Classic cart-pole dynamics (Barto/Sutton parameters) with a continuous
force and a swing-up objective: the pole starts hanging down and the
reward is cos(theta) minus position, velocity and force penalties.
"""
from __future__ import annotations

import math

import torch

from repro_torch.envs.base import Env, EnvSpec, register


@register("cartpole")
class CartpoleSwingup(Env):
    gravity = 9.8
    m_cart = 1.0
    m_pole = 0.1
    length = 0.5          # half pole length
    force_mag = 10.0
    dt = 0.02
    x_limit = 2.4

    def __init__(self):
        self.spec = EnvSpec("cartpole", obs_dim=5, act_dim=1,
                            episode_len=500, difficulty=1)

    def reset_draws(self, n, generator):
        dev = generator.device
        u = torch.rand((2, n), generator=generator, device=dev)
        return {"x": u[0] * 0.2 - 0.1,
                # hanging down (theta = pi), small noise
                "th": math.pi + (u[1] * 0.2 - 0.1)}

    def reset(self, draws):
        """``draws``: x ~ U[-0.1, 0.1), th ~ pi + U[-0.1, 0.1), each (n,)."""
        x = draws["x"]
        zeros = torch.zeros_like(x)
        return {"x": x, "xdot": zeros, "th": draws["th"],
                "thdot": zeros.clone(),
                "t": torch.zeros(x.shape, dtype=torch.int32,
                                 device=x.device)}

    def observe(self, state):
        th = state["th"]
        return torch.stack([state["x"], state["xdot"], torch.cos(th),
                            torch.sin(th), state["thdot"]], dim=-1)

    def step(self, state, action):
        x, xdot = state["x"], state["xdot"]
        th, thdot = state["th"], state["thdot"]
        f = torch.clamp(action[..., 0], -1.0, 1.0) * self.force_mag
        total_m = self.m_cart + self.m_pole
        pm_l = self.m_pole * self.length

        sin, cos = torch.sin(th), torch.cos(th)
        tmp = (f + pm_l * thdot ** 2 * sin) / total_m
        thacc = (self.gravity * sin - cos * tmp) / (
            self.length * (4.0 / 3.0 - self.m_pole * cos ** 2 / total_m))
        xacc = tmp - pm_l * thacc * cos / total_m

        x = torch.clamp(x + self.dt * xdot, -self.x_limit, self.x_limit)
        xdot = xdot + self.dt * xacc
        th = th + self.dt * thdot
        thdot = thdot + self.dt * thacc
        t = state["t"] + 1
        state = {"x": x, "xdot": xdot, "th": th, "thdot": thdot, "t": t}

        reward = (torch.cos(th)               # +1 upright, -1 hanging
                  - 0.01 * x ** 2
                  - 0.001 * thdot ** 2
                  - 0.001 * f ** 2 / self.force_mag ** 2)
        done = t >= self.spec.episode_len
        return state, self.observe(state), reward, done
