"""Reacher2: a 2-link planar arm reaching a random target, batched over
the leading env axis. Counterpart of ``repro/envs/reacher.py``.

Analytic torque-driven dynamics with viscous damping. The reward is the
new tip's distance to the target the step started with, as in the
reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.envs.base import Env, EnvSpec, register


@register("reacher")
class Reacher(Env):
    l1 = 0.5
    l2 = 0.5
    damping = 0.5
    dt = 0.05
    max_torque = 1.0

    def __init__(self):
        self.spec = EnvSpec("reacher", obs_dim=8, act_dim=2,
                            episode_len=150, difficulty=1)

    def reset_draws(self, n, generator):
        dev = generator.device

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=dev)
            return u * (hi - lo) + lo

        return {"q": uniform((n, 2), -math.pi, math.pi),
                "qd": uniform((n, 2), -0.5, 0.5),
                "r": uniform((n,), 0.3, 0.9),
                "ang": uniform((n,), -math.pi, math.pi)}

    def reset(self, draws):
        """``draws``: q ~ U[-pi, pi) and qd ~ U[-0.5, 0.5), each (n, 2);
        the target's radius r ~ U[0.3, 0.9) and angle ang ~ U[-pi, pi),
        each (n,)."""
        r, ang = draws["r"], draws["ang"]
        target = torch.stack([r * torch.cos(ang), r * torch.sin(ang)],
                             dim=-1)
        return {"q": draws["q"], "qd": draws["qd"], "target": target,
                "t": torch.zeros(r.shape, dtype=torch.int32,
                                 device=r.device)}

    def _tip(self, q):
        q0, q01 = q[..., 0], q[..., 0] + q[..., 1]
        x = self.l1 * torch.cos(q0) + self.l2 * torch.cos(q01)
        y = self.l1 * torch.sin(q0) + self.l2 * torch.sin(q01)
        return torch.stack([x, y], dim=-1)

    def observe(self, state):
        q, qd = state["q"], state["qd"]
        return torch.cat([torch.cos(q), torch.sin(q), qd * 0.2,
                          state["target"] - self._tip(q)], dim=-1)

    def step(self, state, action):
        u = torch.clamp(action, -1.0, 1.0) * self.max_torque
        q, qd = state["q"], state["qd"]
        qdd = u - self.damping * qd          # unit-inertia simplification
        qd = torch.clamp(qd + qdd * self.dt, -8.0, 8.0)
        q = q + qd * self.dt
        t = state["t"] + 1
        new = dict(state, q=q, qd=qd, t=t)
        dist = torch.linalg.vector_norm(self._tip(q) - state["target"],
                                        dim=-1)
        reward = -dist - 0.01 * torch.sum(u ** 2, dim=-1)
        done = t >= self.spec.episode_len
        return new, self.observe(new), reward, done
