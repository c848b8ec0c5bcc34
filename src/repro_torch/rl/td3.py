"""TD3 (Fujimoto et al. 2018), the paper's Fig. 8b robustness algorithm.
Counterpart of ``repro/rl/td3.py``.

A deterministic tanh actor and a double-Q ensemble, with target-policy
smoothing and delayed policy updates. One update, in the JAX package's
order:
  1. critic: the target's next action is the *target* actor's, plus the
     smoothing noise ``clip(target_noise * eps, +-noise_clip)``, clipped
     to [-1, 1]; both Q towers take an Adam step against the min of the
     target towers;
  2. actor: its loss reads Q1 of the *new* ensemble. The JAX update
     computes the actor's Adam step every update and keeps it (the
     parameters and the optimizer state, moments and step count) only
     when ``step % policy_delay == 0``. Here the step runs on copies and
     is committed with ``torch.where`` on a device bool, so no update
     reads the step counter back to the host;
  3. polyak averaging of both targets toward the (possibly unchanged)
     online weights, every update.
Every tensor of the state is updated in place.
"""
from __future__ import annotations

import sys
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.rl import networks as nets
from repro_torch.rl.base import (AlgoHP, AlgoState, UpdateStep, batch_mean,
                                 leaf_grads, make_opts, polyak,
                                 register_algo, with_grad)
from repro_torch.train.optimizer import OptState

# the one standard-normal draw of an update: the smoothing noise
UPDATE_NOISES = 1


def init_state(generator: torch.Generator, obs_dim: int, act_dim: int,
               hp: AlgoHP, device="cuda", n_q: int = 2) -> AlgoState:
    """The actor, an ``n_q``-tower Q stack (2; DDPG passes 1), and the
    target ``{"q", "actor"}`` copies of both."""
    dev = resolve_device(device)
    actor = nets.init_mlp_tower(generator, obs_dim, act_dim, hp.hidden,
                                device=dev)
    q = nets.init_ensemble_q(generator, obs_dim, act_dim, n_q, hp.hidden,
                             dev)
    oa, oq, _ = make_opts(hp)
    return AlgoState(
        actor=actor, q=q,
        q_target={"q": tree_map(torch.clone, q),
                  "actor": tree_map(torch.clone, actor)},
        log_alpha=torch.zeros((), device=dev),
        opt_actor=oa.init(actor), opt_q=oq.init(q), opt_alpha=None,
        step=torch.zeros((), dtype=torch.int32, device=dev))


def q1_values(stacked, obs, act) -> torch.Tensor:
    """(B,) Q values of the first tower alone."""
    return nets.tower_q_values(stacked, 0, obs, act)


@torch.no_grad()
def _adam_step_where(opt, grads, opt_state: OptState, params, do):
    """One Adam step of ``params`` and ``opt_state``, kept where the
    device bool ``do`` holds and dropped otherwise, in place."""
    cand_params = tree_map(torch.clone, params)
    cand_state = OptState(step=opt_state.step.clone(),
                          mu=tree_map(torch.clone, opt_state.mu),
                          nu=tree_map(torch.clone, opt_state.nu))
    opt.update(grads, cand_state, cand_params)
    old = tree_leaves(params) + [opt_state.step] + tree_leaves(
        opt_state.mu) + tree_leaves(opt_state.nu)
    new = tree_leaves(cand_params) + [cand_state.step] + tree_leaves(
        cand_state.mu) + tree_leaves(cand_state.nu)
    for o, c in zip(old, new):
        o.copy_(torch.where(do, c, o))


def make_update_step(hp: AlgoHP, obs_dim: int, act_dim: int) -> UpdateStep:
    oa, oq, _ = make_opts(hp)

    def steps(state: AlgoState, batch: Dict[str, torch.Tensor],
              eps_target: torch.Tensor, scale: float = 1.0):
        """One TD3 step on ``batch``. ``eps_target`` is the standard-normal
        (B, act_dim) draw of the target-policy smoothing noise. An
        optional ``batch["weight"]`` (B,) weighs each sample's squared TD
        error in the critic loss; ``td_abs`` stays unweighted. Yields
        twice for the sums over the replicas (``rl.base``): the Q
        gradients with the critic loss and the mean Q, then the actor
        gradients with the actor loss."""
        tgt = state.q_target
        with torch.no_grad():
            noise = torch.clamp(hp.target_noise * eps_target,
                                -hp.noise_clip, hp.noise_clip)
            next_a = torch.clamp(
                nets.det_actor_action(tgt["actor"], batch["next_obs"])
                + noise, -1.0, 1.0)
            q_next = nets.min_q(tgt["q"], batch["next_obs"], next_a)
            disc = batch.get("disc")
            if disc is None:
                disc = hp.gamma * (1.0 - batch["done"])
            target = batch["rew"] + disc * q_next

        with torch.enable_grad():
            qp = with_grad(state.q)
            qs = nets.ensemble_q_values(qp, batch["obs"], batch["act"])
            se = (qs - target) ** 2
            w = batch.get("weight")
            if w is not None:
                se = se * w
            critic_loss = batch_mean(se, scale)
            q_grads = leaf_grads(critic_loss, qp)
        qs = qs.detach()
        *q_grads, critic_loss, qmean = yield [*q_grads, critic_loss.detach(),
                                              batch_mean(qs, scale)]
        oq.update(q_grads, state.opt_q, state.q)

        # delayed policy update, against Q1 of the updated ensemble
        with torch.enable_grad():
            ap = with_grad(state.actor)
            a = nets.det_actor_action(ap, batch["obs"])
            actor_loss = -batch_mean(q1_values(state.q, batch["obs"], a),
                                     scale)
            actor_grads = leaf_grads(actor_loss, ap)
        *actor_grads, actor_loss = yield [*actor_grads, actor_loss.detach()]
        do_pi = torch.remainder(state.step, hp.policy_delay) == 0
        _adam_step_where(oa, actor_grads, state.opt_actor, state.actor, do_pi)

        polyak(tgt["q"], state.q, hp.tau)
        polyak(tgt["actor"], state.actor, hp.tau)
        state.step.add_(1)
        metrics = {"critic_loss": critic_loss, "actor_loss": actor_loss,
                   "q_mean": qmean, "td_abs": torch.abs(qs - target).mean(0)}
        return state, metrics

    return UpdateStep(steps)


def make_act(hp: AlgoHP, deterministic: bool = False):
    """act(actor, obs, eps) -> ``clip(tanh(mlp) + explore_noise * eps,
    +-1)``, or ``tanh(mlp)`` when deterministic (``eps`` ignored)."""
    if deterministic:
        return lambda actor, obs, eps: nets.det_actor_action(actor, obs)
    return lambda actor, obs, eps: torch.clamp(
        nets.det_actor_action(actor, obs) + hp.explore_noise * eps,
        -1.0, 1.0)


register_algo("td3")(sys.modules[__name__])
