"""Soft Actor-Critic (Haarnoja et al. 2018), the paper's main algorithm.
Counterpart of ``repro/rl/sac.py``.

One update, in the JAX package's order:
  1. critic: the target comes from the *old* actor (``eps_next``) and the
     *old* target ensemble; both Q towers take an Adam step;
  2. actor: its loss reads the *new* Q ensemble and the old alpha;
  3. temperature: the gradient of ``-log_alpha * (logp_mean +
     target_entropy)`` with ``logp_mean`` held constant;
  4. polyak averaging of the target toward the new Q.
Every tensor of the state is updated in place.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_map
from repro_torch.rl import networks as nets
from repro_torch.rl.base import (AlgoHP, AlgoState, leaf_grads, make_opts,
                                 polyak, register_algo, with_grad)


# the two standard-normal draws of an update: eps_next, eps_actor
UPDATE_NOISES = 2


def init_state(generator: torch.Generator, obs_dim: int, act_dim: int,
               hp: AlgoHP, device="cuda") -> AlgoState:
    dev = resolve_device(device)
    actor = nets.init_policy(generator, obs_dim, act_dim, hp.hidden, dev)
    q = nets.init_ensemble_q(generator, obs_dim, act_dim, 2, hp.hidden, dev)
    oa, oq, oal = make_opts(hp)
    log_alpha = torch.tensor(math.log(hp.init_alpha), dtype=torch.float32,
                             device=dev)
    return AlgoState(
        actor=actor, q=q,
        q_target=tree_map(torch.clone, q),
        log_alpha=log_alpha,
        opt_actor=oa.init(actor), opt_q=oq.init(q),
        opt_alpha=oal.init(log_alpha),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def make_update_step(hp: AlgoHP, obs_dim: int, act_dim: int):
    oa, oq, oal = make_opts(hp)
    target_entropy = -hp.target_entropy_scale * act_dim

    def update(state: AlgoState, batch: Dict[str, torch.Tensor],
               eps_next: torch.Tensor, eps_actor: torch.Tensor
               ) -> Tuple[AlgoState, Dict[str, torch.Tensor]]:
        """One SAC step on ``batch``. ``eps_next`` / ``eps_actor`` are the
        standard-normal draws (B, act_dim) for the next-state action of
        the critic target and for the actor loss. An optional
        ``batch["weight"]`` (B,) weighs each sample's squared TD error in
        the critic loss (PER importance weights); ``td_abs`` stays
        unweighted."""
        with torch.no_grad():
            alpha = torch.exp(state.log_alpha)
            next_a, next_logp = nets.sample_action(
                state.actor, batch["next_obs"], eps_next)
            q_next = nets.min_q(state.q_target, batch["next_obs"], next_a)
            # "disc" carries gamma^k(1-done) for n-step rows (replay/nstep)
            disc = batch.get("disc")
            if disc is None:
                disc = hp.gamma * (1.0 - batch["done"])
            target = batch["rew"] + disc * (q_next - alpha * next_logp)

        with torch.enable_grad():
            # ---- critic --------------------------------------------------
            qp = with_grad(state.q)
            qs = nets.ensemble_q_values(qp, batch["obs"], batch["act"])
            se = (qs - target) ** 2
            w = batch.get("weight")     # PER importance weights (optional)
            if w is not None:
                se = se * w
            critic_loss = torch.mean(se)
            oq.update(leaf_grads(critic_loss, qp), state.opt_q, state.q)
            qs = qs.detach()
            qmean = qs.mean()
            td_abs = torch.abs(qs - target).mean(0)   # per-sample |TD|

            # ---- actor, against the updated Q ensemble -------------------
            ap = with_grad(state.actor)
            a, logp = nets.sample_action(ap, batch["obs"], eps_actor)
            actor_loss = torch.mean(alpha * logp
                                    - nets.min_q(state.q, batch["obs"], a))
            actor_grads = leaf_grads(actor_loss, ap)
        logp_mean = logp.detach().mean()
        oa.update(actor_grads, state.opt_actor, state.actor)

        # ---- temperature: d/d(log_alpha) of -log_alpha * sg(...) ---------
        if hp.autotune_alpha:
            oal.update([-(logp_mean + target_entropy)], state.opt_alpha,
                       state.log_alpha)

        polyak(state.q_target, state.q, hp.tau)
        state.step.add_(1)
        metrics = {"critic_loss": critic_loss.detach(),
                   "actor_loss": actor_loss.detach(), "q_mean": qmean,
                   "alpha": alpha, "entropy": -logp_mean, "td_abs": td_abs}
        return state, metrics

    return update


def make_act(hp: AlgoHP, deterministic: bool = False):
    """act(actor, obs, eps) -> action; ``eps`` is ignored when
    deterministic."""
    if deterministic:
        return lambda actor, obs, eps: nets.deterministic_action(actor, obs)
    return lambda actor, obs, eps: nets.sample_action(actor, obs, eps)[0]


register_algo("sac")(sys.modules[__name__])
