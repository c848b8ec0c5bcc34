"""DDPG (Lillicrap et al. 2015), the classic deterministic actor-critic.
Counterpart of ``repro/rl/ddpg.py``.

A deterministic tanh actor and a one-tower Q "ensemble" (a stack of 1,
so the ensemble code applies as it is). One update: the critic target
comes from the target actor with no noise and the target Q; the critic
loss and ``td_abs`` read the one tower; the actor loss reads the new Q;
both targets move by polyak averaging. No random draws. Every tensor of
the state is updated in place.
"""
from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch

from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from repro_torch.rl.base import (AlgoHP, AlgoState, leaf_grads, make_opts,
                                 polyak, register_algo, with_grad)

UPDATE_NOISES = 0
# the same exploration: clip(tanh(mlp) + explore_noise * eps, +-1)
make_act = td3.make_act


def init_state(generator: torch.Generator, obs_dim: int, act_dim: int,
               hp: AlgoHP, device="cuda") -> AlgoState:
    return td3.init_state(generator, obs_dim, act_dim, hp, device, n_q=1)


def make_update_step(hp: AlgoHP, obs_dim: int, act_dim: int):
    oa, oq, _ = make_opts(hp)

    def update(state: AlgoState, batch: Dict[str, torch.Tensor]
               ) -> Tuple[AlgoState, Dict[str, torch.Tensor]]:
        """One DDPG step on ``batch``; an optional ``batch["weight"]``
        weighs the squared TD errors, ``td_abs`` stays unweighted."""
        tgt = state.q_target
        with torch.no_grad():
            next_a = nets.det_actor_action(tgt["actor"], batch["next_obs"])
            q_next = nets.ensemble_q_values(tgt["q"], batch["next_obs"],
                                            next_a)[0]
            disc = batch.get("disc")
            if disc is None:
                disc = hp.gamma * (1.0 - batch["done"])
            target = batch["rew"] + disc * q_next

        with torch.enable_grad():
            qp = with_grad(state.q)
            qs = nets.ensemble_q_values(qp, batch["obs"], batch["act"])
            se = (qs[0] - target) ** 2
            w = batch.get("weight")
            if w is not None:
                se = se * w
            critic_loss = torch.mean(se)
            oq.update(leaf_grads(critic_loss, qp), state.opt_q, state.q)
            qs = qs.detach()

            ap = with_grad(state.actor)
            a = nets.det_actor_action(ap, batch["obs"])
            actor_loss = -torch.mean(nets.ensemble_q_values(
                state.q, batch["obs"], a)[0])
            actor_grads = leaf_grads(actor_loss, ap)
        oa.update(actor_grads, state.opt_actor, state.actor)

        polyak(tgt["q"], state.q, hp.tau)
        polyak(tgt["actor"], state.actor, hp.tau)
        state.step.add_(1)
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(), "q_mean": qs.mean(),
                   "td_abs": torch.abs(qs[0] - target)}
        return state, metrics

    return update


register_algo("ddpg")(sys.modules[__name__])
