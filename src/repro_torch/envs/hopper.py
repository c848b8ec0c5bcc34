"""Hopper2D-lite: a planar single-leg locomotor with contact and posture
terms, batched over the leading env axis. Counterpart of
``repro/envs/hopper.py``.

Forward progress needs a pumping gait (thrust in contact, recovery in
flight); an episode ends on a fall. As in the reference, a fallen body
keeps stepping (and paying the fall penalty) wherever the caller ignores
``done``, as the trainer's eval does.
"""
from __future__ import annotations

import torch

from repro_torch.envs.base import Env, EnvSpec, register


@register("hopper")
class Hopper(Env):
    dt = 0.02
    gravity = 9.8
    leg_rest = 1.0

    def __init__(self):
        self.spec = EnvSpec("hopper", obs_dim=8, act_dim=2,
                            episode_len=400, difficulty=2)

    def reset_draws(self, n, generator):
        dev = generator.device
        u = torch.rand((2, n), generator=generator, device=dev)
        return {"vx": u[0] * 0.2 - 0.1,
                "z": self.leg_rest + u[1] * 0.05}

    def reset(self, draws):
        """``draws``: vx ~ U[-0.1, 0.1), z ~ 1 + U[0, 0.05), each (n,)."""
        vx = draws["vx"]

        def zeros():
            return torch.zeros_like(vx)

        return {"x": zeros(), "vx": vx, "z": draws["z"], "vz": zeros(),
                "leg": zeros(),            # leg extension (-0.5 .. 0.5)
                "pitch": zeros(),
                "t": torch.zeros(vx.shape, dtype=torch.int32,
                                 device=vx.device)}

    def observe(self, state):
        return torch.stack([
            state["z"], state["vx"] * 0.3, state["vz"] * 0.3, state["leg"],
            state["pitch"], torch.sin(state["pitch"]),
            torch.clamp(state["z"] - self.leg_rest, -1, 1),
            (state["t"] % 50) / 50.0], dim=-1)

    def step(self, state, action):
        u_leg = torch.clamp(action[..., 0], -1.0, 1.0)     # leg thrust
        u_hip = torch.clamp(action[..., 1], -1.0, 1.0)     # hip / pitch
        z, vz, vx = state["z"], state["vz"], state["vx"]
        leg = torch.clamp(state["leg"] + 2.0 * u_leg * self.dt, -0.5, 0.5)
        foot = z - (self.leg_rest + leg)
        contact = foot <= 0.0
        thrust = torch.clamp(u_leg, min=0.0)
        # spring-like ground force when in contact, boosted by leg thrust
        f_ground = torch.where(contact, -80.0 * foot - 8.0 * vz
                               + 30.0 * thrust, 0.0)
        vz = vz + (f_ground - self.gravity) * self.dt
        z = torch.clamp(z + vz * self.dt, min=0.3)
        # forward thrust only while pushing off the ground, steered by hip
        pitch = torch.clamp(state["pitch"] + 1.5 * u_hip * self.dt,
                            -0.8, 0.8)
        ax = torch.where(contact, 12.0 * thrust * torch.sin(pitch)
                         - 1.0 * vx, -0.2 * vx)
        vx = torch.clamp(vx + ax * self.dt, -5.0, 10.0)
        x = state["x"] + vx * self.dt
        t = state["t"] + 1
        new = {"x": x, "vx": vx, "z": z, "vz": vz, "leg": leg,
               "pitch": pitch, "t": t}
        fallen = (z < 0.55) | (torch.abs(pitch) > 0.75)
        reward = (1.0 * vx                        # forward progress
                  + 0.5                           # alive bonus
                  - 0.05 * (u_leg ** 2 + u_hip ** 2)
                  - torch.where(fallen, 5.0, 0.0))
        done = fallen | (t >= self.spec.episode_len)
        return new, self.observe(new), reward, done
