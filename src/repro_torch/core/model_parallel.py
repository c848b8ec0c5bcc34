"""Actor-critic model parallelism over the trainer's mesh (paper §3.2.2,
Fig. 2b) and its data-parallel baseline (Fig. 2a), and the losses of the
arch-backbone towers (``make_arch_spreeze_losses``, at the end).
Counterpart of ``repro/core/model_parallel.py``.

The mesh is an ("ac", "batch") grid of devices (``launch.mesh``). Its G
batch groups (``launch.mesh.ring_shard_groups``: the batch axis under
``ac``, every device under ``dp``) each hold one shard of the replay ring
and one replica of the algorithm state, and each update runs once a
group on its B/G rows of the batch:

* ``placement="ac"``: group g is batch column g. Its actor, ``log_alpha``,
  their Adam states and TD3's and DDPG's target actor sit on ``(0, g)``;
  Q tower i with its target and its Adam moments on ``(i, g)`` (a
  ``rl.networks.PlacedEnsemble``), so each ac row updates its own towers.
  Only rows, actions and (B/G,) Q values cross between ac rows.
* ``placement="dp"``: group g is device g of the grid in row-major order,
  and every parameter and Adam state is replicated on it.

In both, each replica's gradients are summed over the groups once
(``rl.base.drive_replicas``: the update's losses are the groups' shares
of the single-device mean) and every replica applies the same sum, so
the replicas stay bitwise equal. The ring's G shards live on the groups'
devices; its cursor, the sampler, the env states and the draws on the
primary device ``(0, 0)``, with replica 0's actor.

``place_state`` / ``place_replay`` lay a whole ``AlgoState``,
``ReplayState`` or ``PrioritizedState`` out on the mesh (copies), and
``gather_state`` / ``gather_replay`` give the whole form back on the
primary device, the form checkpoints, tests and the eval consumers read.

The dry run's entry (``make_spreeze_update``, ``standard_rules_for_rl``,
``_state_shardings_from_shapes``) builds the RL update of the reference's
production mesh on the port's grid: ac = pod, batch = data, the towers
replicated over ``model`` as the reference replicates them, so each
device's share is the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (AxisMesh, Mesh, MeshRules,
                                              check_on_group, group_devices,
                                              spreeze_rules, to_group,
                                              trainer_rules)
from repro_torch.replay.buffer import ReplayState
from repro_torch.replay.prioritized import PrioritizedState
from repro_torch.rl import networks as nets
from repro_torch.rl.base import (AlgoHP, AlgoState, UpdateStep,
                                 drive_replicas, get_algo)
from repro_torch.rl.networks import PlacedEnsemble
from repro_torch.train.optimizer import Optimizer, OptState


class MeshLayout:
    """Where a mesh trainer's carry lives: the rules, the G batch groups'
    devices (each group's ring shard and replica home), and under ``ac``
    the devices of each group's Q parts."""

    def __init__(self, mesh: Mesh, placement: str = "ac"):
        self.mesh, self.placement = mesh, placement
        self.rules = trainer_rules(mesh, placement)
        self.devices = group_devices(self.rules)
        self.groups = len(self.devices)
        self.primary = mesh.primary
        self.ac_parts = self.rules.axis_size(self.rules.ac)

    def tower_devices(self, g: int) -> List[torch.device]:
        """The devices of group g's Q parts: ac row i's ``(i, g)``, or the
        group's own device when the ensemble is not split."""
        if self.ac_parts == 1:
            return [self.devices[g]]
        return [self.mesh.device(i, g) for i in range(self.ac_parts)]


class PlacedState(NamedTuple):
    """A mesh trainer's algorithm state: one ``AlgoState`` replica a batch
    group, replica 0 on the primary device."""
    replicas: Tuple[AlgoState, ...]

    @property
    def actor(self):
        """Replica 0's actor: the sampler's, eval's and the snapshots'."""
        return self.replicas[0].actor


# --------------------------------------------------------------------------- #
# the algorithm state
# --------------------------------------------------------------------------- #

def _has_target_actor(q_target) -> bool:
    """TD3's and DDPG's target holder ``{"q", "actor"}`` (SAC's target is
    a Q stack)."""
    return isinstance(q_target, dict) and set(q_target) == {"q", "actor"}


def _place_ensemble(stacked, layout: MeshLayout, g: int):
    """Group g's copy of a Q stack: on its device, or split into the
    layout's ac parts, part i on ``(i, g)``."""
    devs = layout.tower_devices(g)
    if len(devs) == 1:
        return to_group(stacked, devs[0], copy=True)
    m = next(iter(stacked.values()))["w"].shape[0] // len(devs)
    return PlacedEnsemble(
        to_group(tree_map(lambda x: x[i * m:(i + 1) * m], stacked), dev,
                 copy=True) for i, dev in enumerate(devs))


def _gather_ensemble(q, primary):
    """The whole Q stack on ``primary``: a placed ensemble's parts joined
    in tower order (a copy), else ``q`` itself."""
    if isinstance(q, PlacedEnsemble):
        return tree_map(lambda *parts: torch.cat(
            [to_group(p, primary) for p in parts]), q[0], *q[1:])
    return to_group(q, primary)


def _map_q_side(state: AlgoState, fn_q, fn_actor) -> AlgoState:
    """``state`` with ``fn_q`` over its Q stacks (the ensemble, its target
    and its Adam moments) and ``fn_actor`` over everything else."""
    def opt(o: OptState, fn):
        return OptState(step=fn_actor(o.step), mu=fn(o.mu), nu=fn(o.nu))

    tgt = state.q_target
    tgt = ({"q": fn_q(tgt["q"]), "actor": fn_actor(tgt["actor"])}
           if _has_target_actor(tgt) else fn_q(tgt))
    return AlgoState(
        actor=fn_actor(state.actor), q=fn_q(state.q), q_target=tgt,
        log_alpha=fn_actor(state.log_alpha),
        opt_actor=opt(state.opt_actor, fn_actor),
        opt_q=opt(state.opt_q, fn_q),
        opt_alpha=(None if state.opt_alpha is None
                   else opt(state.opt_alpha, fn_actor)),
        step=fn_actor(state.step))


def place_state(state: AlgoState, layout: MeshLayout) -> PlacedState:
    """One replica of the whole ``state`` a batch group (fresh copies)."""
    return PlacedState(tuple(
        _map_q_side(state, lambda q, g=g: _place_ensemble(q, layout, g),
                    lambda x, dev=dev: to_group(x, dev, copy=True))
        for g, dev in enumerate(layout.devices)))


def gather_state(state: PlacedState, layout: MeshLayout) -> AlgoState:
    """The whole ``AlgoState`` on the primary device, from replica 0: its
    own tensors, and the placed Q stacks joined (a copy)."""
    return _map_q_side(state.replicas[0],
                       lambda q: _gather_ensemble(q, layout.primary),
                       lambda x: to_group(x, layout.primary))


def replace_actor(state, actor, layout: Optional[MeshLayout]):
    """``state`` with its actor replaced by ``actor``: an ``AlgoState``'s
    (no layout), or every replica's by a copy."""
    if layout is None:
        return state._replace(actor=actor)
    return PlacedState(tuple(
        rep._replace(actor=to_group(actor, dev, copy=True))
        for rep, dev in zip(state.replicas, layout.devices)))


# --------------------------------------------------------------------------- #
# the replay ring
# --------------------------------------------------------------------------- #

def _split(x: torch.Tensor, layout: MeshLayout) -> List[torch.Tensor]:
    rows = x.shape[0] // layout.groups
    return [to_group(x.narrow(0, g * rows, rows), dev, copy=True)
            for g, dev in enumerate(layout.devices)]


def _join(shards: List[torch.Tensor], layout: MeshLayout) -> torch.Tensor:
    return torch.cat([to_group(s, layout.primary) for s in shards])


def place_replay(replay, layout: MeshLayout):
    """The ring split into the groups' contiguous shards (fresh copies;
    each field a list of G shards), the cursor on the primary device.
    Takes a ``ReplayState`` or a ``PrioritizedState``."""
    if isinstance(replay, PrioritizedState):
        return PrioritizedState(
            base=place_replay(replay.base, layout),
            priorities=_split(replay.priorities, layout),
            max_priority=to_group(replay.max_priority, layout.primary,
                                  copy=True))
    return ReplayState(
        data={k: _split(v, layout) for k, v in replay.data.items()},
        ptr=to_group(replay.ptr, layout.primary, copy=True),
        size=to_group(replay.size, layout.primary, copy=True))


def gather_replay(replay, layout: MeshLayout):
    """The whole ring on the primary device: the shards joined in group
    order (a copy), the cursor as it is."""
    if isinstance(replay, PrioritizedState):
        return PrioritizedState(base=gather_replay(replay.base, layout),
                                priorities=_join(replay.priorities, layout),
                                max_priority=replay.max_priority)
    return ReplayState(data={k: _join(v, layout)
                             for k, v in replay.data.items()},
                       ptr=replay.ptr, size=replay.size)


def whole_state(trainer) -> AlgoState:
    """A trainer's ``AlgoState`` in the single-device form."""
    if trainer.layout is None:
        return trainer.state
    return gather_state(trainer.state, trainer.layout)


def whole_replay(trainer):
    """A trainer's ring in the single-device form."""
    if trainer.layout is None:
        return trainer.replay
    return gather_replay(trainer.replay, trainer.layout)


# --------------------------------------------------------------------------- #
# the update
# --------------------------------------------------------------------------- #

class MeshUpdate:
    """An algorithm's update over the mesh: called as the single-device
    update is, with a ``PlacedState``, a batch of per-group rows (each
    field a list of G tensors, group g's on its device, as
    ``replay.buffer.sample`` gives them on a mesh) and the whole (B, ...)
    noises on the primary device, which it splits by rows. Each group
    runs the algorithm's ``steps`` on its B/G rows at scale 1/G, in lock
    step with the others (``rl.base.drive_replicas``). Returns the state
    and group 0's metrics, whose reductions are over the whole batch,
    with ``td_abs`` joined in group order on the primary device."""

    def __init__(self, update: UpdateStep, layout: MeshLayout):
        self.update, self.layout = update, layout

    def __call__(self, state: PlacedState, batch: Dict[str, List],
                 *noises: torch.Tensor):
        layout = self.layout
        G = layout.groups
        gens = []
        for g, (rep, dev) in enumerate(zip(state.replicas, layout.devices)):
            local = {k: v[g] for k, v in batch.items()}
            check_on_group(dev, local, f"group {g}'s batch")
            eps = [to_group(e.narrow(0, g * (e.shape[0] // G),
                                     e.shape[0] // G), dev) for e in noises]
            gens.append(self.update.steps(rep, local, *eps, scale=1.0 / G))
        results = drive_replicas(gens)
        metrics = dict(results[0][1])
        metrics["td_abs"] = torch.cat([to_group(m["td_abs"], layout.primary)
                                       for _, m in results])
        return state, metrics


# --------------------------------------------------------------------------- #
# the dry run's entry: the Spreeze update of the production mesh
# --------------------------------------------------------------------------- #

def standard_rules_for_rl(mesh: AxisMesh) -> MeshRules:
    """Fig. 2a data parallelism: no ac axis, the batch over every data-ish
    axis, the parameters replicated (MLP towers are tiny: splitting them
    would only add gathers)."""
    batch = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return MeshRules(mesh=mesh, batch=batch or ("data",))


def _spreeze_rules(mesh: AxisMesh, placement: str) -> MeshRules:
    """The reference's rules of ``make_spreeze_update``: ``dp`` the data
    parallel ones; ``ac`` the Spreeze rules, a single pod borrowing its
    data axis for the ensemble."""
    if placement == "dp":
        return standard_rules_for_rl(mesh)
    rules = spreeze_rules(mesh)
    if rules.ac is None:
        rules = MeshRules(mesh=mesh, batch=("data",), seq=rules.seq,
                          fsdp=rules.fsdp, tp=rules.tp, ac="data")
    return rules


def spreeze_grid(mesh: AxisMesh) -> Mesh:
    """The port's ("ac", "batch") grid for the production ``mesh``: ac =
    pod (1 for a single pod), batch = data; every position names the meta
    device (a distinct device object a position, which a census tells
    apart)."""
    ac, batch = mesh.shape.get("pod", 1), mesh.shape["data"]
    return Mesh([[torch.device("meta") for _ in range(batch)]
                 for _ in range(ac)])


def make_spreeze_update(mesh: AxisMesh, *, algo: str = "sac",
                        obs_dim: int = 26, act_dim: int = 6,
                        batch_size: int = 8192,
                        hp: Optional[AlgoHP] = None,
                        placement: str = "ac", grid: Optional[Mesh] = None):
    """The reference's RL update on the production ``mesh``, as the port
    runs it on the meta device: on ``grid`` (``spreeze_grid(mesh)`` unless
    given),
    under the trainer's ``placement``. ``ac`` (Fig. 2b): each ac row (pod)
    holds one Q tower of every batch group, no gradient crosses the rows.
    ``dp`` (Fig. 2a): every group a replica of everything, the rows over
    all the groups, the gradients summed over them.

    -> (update_fn, state, batch, noises, in_shardings): ``update_fn(state,
    batch, *noises)`` a ``MeshUpdate``, ``state`` placed on the grid
    (``PlacedState``), ``batch`` each field's G row shards, ``noises``
    the update's (batch_size, act_dim) standard-normal draws on the
    primary device, and ``in_shardings`` the reference's splits of the
    whole state, the batch and the key under its rules."""
    hp = hp or AlgoHP(algo=algo)
    rules = _spreeze_rules(mesh, placement)
    mod = get_algo(algo)
    grid = grid or spreeze_grid(mesh)
    layout = MeshLayout(grid, placement)
    dev = layout.primary
    gen = torch.Generator().manual_seed(0)
    whole = mod.init_state(gen, obs_dim, act_dim, hp, device=dev)
    state = place_state(whole, layout)
    widths = {"obs": obs_dim, "act": act_dim, "rew": 0, "next_obs": obs_dim,
              "done": 0}
    rows = {k: torch.zeros((batch_size, w) if w else (batch_size,),
                           device=dev) for k, w in widths.items()}
    batch = {k: _split(v, layout) for k, v in rows.items()}
    noises = [torch.zeros((batch_size, act_dim), device=dev)
              for _ in range(mod.UPDATE_NOISES)]
    in_shardings = (_state_shardings_from_shapes(whole, rules),
                    {k: (rules.batch,) + (None,) * (v.dim() - 1)
                     for k, v in rows.items()},
                    ())
    update = MeshUpdate(mod.make_update_step(hp, obs_dim, act_dim), layout)
    return update, state, batch, noises, in_shardings


def _state_shardings_from_shapes(state: AlgoState, rules: MeshRules):
    """The reference's splits of a whole ``AlgoState`` under ``rules``:
    the Q side (the ensemble, its target and its Adam moments) with its
    leading dim over ``ac``, everything else (the actor, the
    temperature, the step counters) replicated. One entry a dim."""
    def ens(leaf):
        if leaf.dim() == 0 or rules.ac is None:
            return (None,) * leaf.dim()
        return (rules.ac,) + (None,) * (leaf.dim() - 1)

    def rep(leaf):
        return (None,) * leaf.dim()

    return _map_q_side(state, lambda q: tree_map(ens, q),
                       lambda x: tree_map(rep, x))


# --------------------------------------------------------------------------- #
# arch-backbone Spreeze towers (RLHF-scale): an actor LM and two critic LMs
# --------------------------------------------------------------------------- #

class _TanhLogDet(torch.autograd.Function):
    """``log(clamp(1 - tanh(pre)^2, 1e-6))``, the reference's value, with
    its exact derivative ``-2 tanh(pre)`` (0 where the clamp holds). The
    chain rule through ``1 / (1 - a^2)`` and tanh's ``1 - a^2`` divides
    two roundings of a small difference where |a| is near 1 (~1e-4
    relative at a = 0.9996), enough to move a float32 actor gradient by
    2e-5 of its largest value."""

    @staticmethod
    def forward(ctx, pre):
        a = torch.tanh(pre)
        u = 1 - a ** 2
        ctx.save_for_backward(a, u)
        return torch.log(torch.clamp(u, min=1e-6))

    @staticmethod
    def backward(ctx, g):
        a, u = ctx.saved_tensors
        return g * (-2 * a) * (u > 1e-6)


def make_arch_spreeze_losses(cfg: ModelConfig, act_dim: int = 16,
                             dtype=torch.bfloat16,
                             hp: Optional[AlgoHP] = None):
    """-> (actor_loss, critic_loss), whose towers are ``cfg`` backbones
    (``rl.networks``' arch towers; the critics a stacked pair). Each
    tower's backbone runs once for the two losses: each actor-loss call
    takes the forwards of the critic-loss call before it, which must be
    on the same actor, critics and tokens.

    ``critic_loss(q, q_target, actor, tokens, act, rew, done)``: both
    critics' Q(s, act) regressed onto ``rew + hp.gamma * (1 - done) *
    min_i Q_target_i(s, tanh(mean))``. The target (the target critics, and
    the actor's mean, detached) carries no gradient, the reference's
    ``stop_gradient``: none reaches the target critics or the actor. The
    reference's key is unused here, so the loss takes no draw. It runs
    the actor with a graph and keeps its ``(mean, log_std)`` and the
    critics' detached backbone hidden states for the actor loss.

    ``actor_loss(actor, q, tokens, eps)``: from the critic loss's
    ``(mean, log_std)``, the tanh-Gaussian action of the standard-normal
    draw ``eps`` (B, act_dim), its log-prob with the ``log(clamp(1 - a^2,
    1e-6))`` correction, and ``mean(0.2 * logp - min_i Q_i(s, a))`` at the
    fixed temperature 0.2. It is differentiated with respect to the
    actor: the critics enter as constants, their heads over the handed
    hidden states (``arch_min_q_of_action``). Called with no critic-loss
    forwards waiting, it raises ``ValueError``.
    """
    hp = hp or AlgoHP()
    half_log_2pi = 0.5 * math.log(2 * math.pi)
    shared = {}       # the critic loss's forwards, until the actor loss

    def actor_loss(actor_params, q_params, tokens, eps):
        if not shared:
            raise ValueError("the arch actor loss takes the critic loss's "
                             "forwards: call critic_loss first, on the "
                             "same towers and tokens")
        mean, log_std = shared.pop("policy")
        hidden = shared.pop("q_hidden")
        pre = mean + torch.exp(log_std) * eps
        a = torch.tanh(pre)
        logp = (-0.5 * eps ** 2 - log_std - half_log_2pi).sum(-1)
        logp = logp - _TanhLogDet.apply(pre).sum(-1)
        q = nets.arch_min_q_of_action(q_params, tokens, a, cfg, dtype=dtype,
                                      hidden=hidden)
        return torch.mean(0.2 * logp - q)

    def critic_loss(q_params, q_target_params, actor_params, tokens, act,
                    rew, done):
        hidden = []
        q_pred = nets.arch_ensemble_q_values(q_params, tokens, act, cfg,
                                             dtype=dtype, hidden=hidden)
        mean, log_std = nets.arch_policy_dist(actor_params, tokens, cfg,
                                              dtype=dtype)
        shared.update(policy=(mean, log_std), q_hidden=hidden)
        with torch.no_grad():
            q_next = nets.arch_ensemble_q_values(
                q_target_params, tokens, torch.tanh(mean.detach()), cfg,
                dtype=dtype).min(dim=0).values
            target = rew + hp.gamma * (1 - done) * q_next
        return torch.mean((q_pred - target[None]) ** 2)

    return actor_loss, critic_loss


def make_arch_spreeze_update(cfg: ModelConfig, opt: Optimizer,
                             act_dim: int = 16, dtype=torch.bfloat16):
    """One update of the arch towers -> ``update(actor, q, q_target,
    opt_actor, opt_q, tokens, act, rew, done, eps) -> (critic_loss,
    actor_loss)``: the critic loss's gradient over the critics and the
    actor loss's over the actor, both at the current parameters (the
    reference's ``lower_spreeze_arch`` update), then one step of ``opt``
    (whose ``init`` made ``opt_actor`` and ``opt_q``) on each, in place.
    The actor's and critics' leaves must require grad. The losses stay
    device scalars. The actor loss takes the critic loss's forwards, so
    each of the three differentiated towers and the two target critics
    runs its backbone once an update: 5 forwards."""
    actor_loss, critic_loss = make_arch_spreeze_losses(cfg, act_dim, dtype)

    def update(actor, q, q_target, opt_actor: OptState, opt_q: OptState,
               tokens, act, rew, done, eps):
        trace.count("arch.updates")
        with trace.first("arch.update"):
            with trace.span("arch.critic_loss"):
                cl = critic_loss(q, q_target, actor, tokens, act, rew, done)
            with trace.span("arch.critic_grad"):
                gq = tower_grads(cl, q)
            with trace.span("arch.actor_loss"):
                al = actor_loss(actor, q, tokens, eps)
            with trace.span("arch.actor_grad"):
                ga = tower_grads(al, actor)
            with trace.span("arch.adam"):
                opt.update(gq, opt_q, q)
            with trace.span("arch.adam"):
                opt.update(ga, opt_actor, actor)
        return cl.detach(), al.detach()

    return update


def tower_grads(loss: torch.Tensor, params) -> List[torch.Tensor]:
    """Gradients in the order of ``tree_leaves(params)``; zeros for a leaf
    the loss does not reach, as JAX gives."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]
