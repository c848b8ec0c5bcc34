"""The Spreeze trainer: sampler chunk -> ring write -> K updates, fused
into megasteps of R rounds, or run round by round. Counterpart of the
single-device path of ``repro/core/pipeline.py``, with SAC, TD3 or DDPG,
uniform or prioritized replay, and the pendulum, cartpole, reacher and
hopper envs.

One round steps ``num_envs`` envs for ``chunk_len`` steps under the
actor, applies the n-step transform, writes the rows into the
device-resident replay ring (the ``ring_write`` kernel, one launch for
all the fields) and runs ``updates_per_round`` updates, each on a batch
that the ``ring_gather`` kernel reads (one launch for all the fields).
With ``prioritized=True`` the same write also tags the new rows with the
max priority (one more field of that launch), and each update draws its
batch with the ``per_topk`` kernel, gathers the drawn rows' priority
mass (one more field of the gather's launch), weighs the critic loss by
importance and writes the
new priorities back with ``priority_scatter``. ``megastep`` runs
``rounds_per_dispatch`` rounds in one call. It runs eagerly: the
state, the ring and the optimizer moments are updated in place (the
analogue of the JAX megastep's buffer donation), and nothing in a
megastep reads a tensor back to the host.

**The eager loop** (``fused=False``, and always under the ``queue``
transfer or ``sync_mode``): one round at a time, sampler chunk ->
``transfer.push`` -> ``transfer.flush`` -> update round, so the Fig. 4a
ablations measure their handoffs. ``transfer="queue"`` stages the
experience in a bounded host queue (``replay/host_queue.py``) and writes
it into the ring one drain at a time; ``sync_mode`` synchronises the
device after the push and after the update round (the reference's two
``block_until_ready`` handoff waits).

**The async host runtime** (``async_eval``, on unless ``sync_mode``):
at an eval or viz window the train thread only *publishes* a snapshot
of the actor (a ``clone`` enqueued on its stream before the next
megastep's Adam step, and a CUDA event recorded after it) into
``core.runtime``'s latest-wins mailbox and goes on. Worker threads run
eval and the viz rollout, each on its own CUDA stream that waits on the
snapshot's event; a worker's ``float(...)`` synchronises only its own
stream. ``weight_sync="ssd"`` sends each snapshot through an ``.npz``
save and restore on the runtime's channel thread. Eval and viz draw
their resets from generators keyed by the round index, so inline and
async eval score the same numbers.

Randomness comes from a draw source (``Draws`` by default: Philox
generators on the trainer's device). A caller may pass another with the
same methods, for example one that replays another implementation's
draws.

**Resilience** (``core.faults``, ``train.resume``): with ``snapshot_dir``
the loop writes a bundle of its whole state every
``snapshot_every_rounds`` (published to the runtime's state worker, or
written inline), and ``train(resume_from=path)`` continues a run from
one, bitwise equal to a run that never stopped. Each megastep also
computes ``carry_finite``, a device flag over the actor and the round
metrics, copied to pinned host memory behind a CUDA event; the loop
reads a flag only once its event has completed, and on a False one
backs the learning rate off and rolls back to the latest snapshot.
``fault_plan`` injects preemption, a NaN, SSD and eval-worker failures
and hangs at fixed rounds. ``sanitize`` runs each megastep (each half of
an eager round) under ``torch.cuda.set_sync_debug_mode("error")``, so
any operation that waits for the card raises, and checks the carry for
non-finite values after it.

**The multi-device megastep** (``mesh``, ``placement``): with an ("ac",
"batch") mesh from ``launch.mesh.make_ac_mesh`` the fused megastep runs
over the mesh from this one process (``core.model_parallel``): the ring
is split into the batch groups' shards (one ring-write, gather, top-k
and scatter launch a group), and each update runs once a group on its
rows of the batch, the gradients summed over the groups. Under
``placement="ac"`` (paper §3.2.2, Fig. 2b) each ac row updates its own Q
towers and only (B,)-sized rows and Q values cross between rows; under
``"dp"`` (Fig. 2a) every parameter is replicated. ``state`` and
``replay`` then hold the placed forms (``model_parallel.whole_state`` /
``whole_replay`` give the single-device forms); the sampler, the env
states, the draws, eval, viz and the snapshots read replica 0's actor on
the mesh's primary device.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import os
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import exact_float32, resolve_device, sync_debug_mode, trace
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.analysis.hlolint.contract import (MOVE, CollectiveContract,
                                                   CollectiveRule,
                                                   EntrypointContract)
from repro_torch.core import faults
from repro_torch.core import model_parallel as mp
from repro_torch.core import runtime as rt
from repro_torch.core.transfer import make_transfer
from repro_torch.envs import base as env_base
from repro_torch.kernels import ops as kops
from repro_torch.replay import buffer as rb
from repro_torch.replay import prioritized as per
from repro_torch.replay.nstep import nstep_chunk
from repro_torch.rl.base import AlgoHP, get_algo
from repro_torch.train import checkpoint
from repro_torch.train import resume as resume_lib

# --------------------------------------------------------------------------- #
# hlolint contracts (checked by `python -m repro_torch.analysis.hlolint`)
# --------------------------------------------------------------------------- #
# What a megastep, a sampler chunk and an update round may do when they
# run; the builders live in repro_torch.analysis.hlolint.entrypoints.
# Dims are expressions over the probe's symbols (capacity, batch, groups,
# k == batch for PER, rows a round, rounds, updates a round, hidden).

#: the sharded megastep's moves between groups, uniform replay: the ring
#: write's and the gather's (kernels.ops), and the gradient sums over the
#: groups. Every move stays below the replay capacity but a hidden x
#: hidden gradient's, which is as large as the towers, not the pool.
MEGASTEP_COLLECTIVE_CONTRACT = CollectiveContract(
    allow=kops.RING_WRITE_MOVES + kops.RING_GATHER_MOVES + (
        CollectiveRule(MOVE, ("*", "hidden", "hidden"), cap_exempt=True),
        CollectiveRule(MOVE, ("hidden", "hidden"), cap_exempt=True),
        # the other parameter-shaped sums, (B/G,) Q values and actions
        CollectiveRule(MOVE, ("*", "...")),
    ),
    max_elems="capacity")

#: PER adds the group-local selection's moves
PER_MEGASTEP_COLLECTIVE_CONTRACT = CollectiveContract(
    allow=MEGASTEP_COLLECTIVE_CONTRACT.allow + kops.PER_TOPK_MOVES,
    max_elems="capacity")

#: one ring write a round and one gather an update, each once a group
MEGASTEP_LAUNCHES = {"ring_write": "rounds*groups",
                     "ring_gather": "rounds*updates*groups"}
#: PER adds one selection and one scatter an update, each once a group
PER_MEGASTEP_LAUNCHES = dict(MEGASTEP_LAUNCHES,
                             per_topk="rounds*updates*groups",
                             priority_scatter="rounds*updates*groups")

_STATE = ("state", "replay")
HLOLINT_CONTRACTS = (
    # the state, its Adam moments and the ring updated in place, nothing
    # moved between groups on one device, float32 end to end
    EntrypointContract(name="megastep", module=__name__, inplace=True,
                       state=_STATE, launches=MEGASTEP_LAUNCHES),
    EntrypointContract(name="megastep_per", module=__name__, inplace=True,
                       state=_STATE, launches=PER_MEGASTEP_LAUNCHES),
    EntrypointContract(name="megastep_sharded", module=__name__,
                       inplace=True, state=_STATE,
                       collectives=MEGASTEP_COLLECTIVE_CONTRACT,
                       launches=MEGASTEP_LAUNCHES),
    EntrypointContract(name="megastep_sharded_per", module=__name__,
                       inplace=True, state=_STATE,
                       collectives=PER_MEGASTEP_COLLECTIVE_CONTRACT,
                       launches=PER_MEGASTEP_LAUNCHES),
    # the env states are made anew at every step (the envs are pure
    # functions of them), so the sampler updates nothing in place
    EntrypointContract(name="sampler_chunk", module=__name__),
    EntrypointContract(name="update_round", module=__name__, inplace=True,
                       state=_STATE,
                       launches={"ring_gather": "updates"}),
)

#: held by a sanitized dispatch for its whole scope and by a worker of a
#: sanitized trainer for its whole body: the sync debug mode is
#: process-wide, so a worker's host read must never overlap a dispatch
#: under "error"
_SYNC_GATE = threading.Lock()


@dataclass
class SpreezeConfig:
    env_name: str = "pendulum"
    algo: str = "sac"
    # parallelization hyperparameters (the two the paper auto-tunes)
    num_envs: int = 16            # "number of sampling processes"
    batch_size: int = 8192
    # pipeline
    replay_capacity: int = 262_144
    warmup_frames: int = 2_048
    chunk_len: int = 32           # env steps per sampler chunk
    updates_per_round: int = 4    # updates per round
    rounds_per_dispatch: int = 4  # rounds fused into one megastep
    fused: Optional[bool] = None  # None = auto (shared transfer + async)
    transfer: str = "shared"      # shared | queue
    queue_size: int = 20_000
    sync_mode: bool = False       # Fig. 4a baseline: block on every handoff
    prioritized: bool = False     # APE-X-style PER on the shared pool
    per_alpha: float = 0.6
    per_beta: float = 0.4
    nstep: int = 1                # n-step returns (APE-X uses 3)
    weight_sync: str = "live"     # live | ssd (paper's channel)
    # multi-device megastep (paper §3.2.2, Fig. 2b/3): an ("ac","batch")
    # mesh (``launch.mesh.make_ac_mesh``) — the double-Q ensemble splits
    # over ``ac`` (each ac row updates its own towers), the replay ring's
    # rows over ``batch``, the actor stays on ac row 0. None = the
    # single-device megastep.
    mesh: Optional[Any] = None
    placement: str = "ac"         # ac (Fig. 2b) | dp (Fig. 2a baseline)
    # the megastep clones the actor for eval/viz at its end, before the
    # next megastep updates the parameters in place
    overlap_eval: bool = False
    # eval/vis "processes"
    eval_every_rounds: int = 50   # 0 = off
    eval_episodes: int = 4
    viz_every_rounds: int = 0     # 0 = off; paper's visualization process
    viz_dir: Optional[str] = None  # .npz trajectories land here
    # host-side async runtime (core.runtime): eval/viz/SSD run on worker
    # threads fed by a latest-wins snapshot mailbox. None = auto (async
    # unless sync_mode: the Fig. 4a ablation keeps the inline path).
    async_eval: Optional[bool] = None
    eval_workers: int = 1
    viz_workers: int = 1
    # worker supervision (core.runtime.SupervisorPolicy)
    supervise: bool = True        # retry/degrade workers vs fail fast
    worker_retry_budget: int = 3  # per-consumer crash/hang budget
    worker_heartbeat_s: float = 30.0  # hung-worker watchdog (0 = off)
    # sanitize: each megastep (each half of an eager round) runs under
    # torch.cuda.set_sync_debug_mode("error"), so an operation that waits
    # for the card raises, and the carry is checked for non-finite values
    # after it (the reference's transfer_guard + debug_nans)
    sanitize: bool = False
    # resilience (core.faults, train.resume): full-state snapshots,
    # fault injection, rollback on a non-finite megastep carry
    snapshot_dir: Optional[str] = None  # None = periodic snapshots off
    snapshot_every_rounds: int = 50     # full-state snapshot cadence
    # wall-clock floor between periodic snapshots (preemption safety
    # bounds lost time, not rounds); 0 pins snapshots to exact rounds
    snapshot_min_interval_s: float = 5.0
    keep_snapshots: int = 3             # last-K retention
    max_rollbacks: int = 3        # finite-guard rollback budget
    rollback_lr_backoff: float = 0.5  # lr *= this on every rollback
    fault_plan: Optional[faults.FaultPlan] = None  # injection schedule
    seed: int = 0
    hp: AlgoHP = field(default_factory=AlgoHP)
    device: str = "cuda"

    def __post_init__(self):
        if self.hp.algo != self.algo:
            self.hp = AlgoHP(**{**self.hp.__dict__, "algo": self.algo})


@dataclass
class TrainHistory:
    """Metrics the paper reports (Tables 2/3, Fig. 5). The Hz metrics
    count post-warmup frames over post-warmup wall time; warmup frames
    are reported separately in ``warmup_frames``.

    Recording is thread-safe and **round-ordered**: the async runtime's
    eval workers may finish out of publish order, but entries are
    inserted by ``round_i``, so async and inline runs record in the same
    order."""
    times: List[float] = field(default_factory=list)
    eval_returns: List[float] = field(default_factory=list)
    env_frames: List[int] = field(default_factory=list)
    update_steps: List[int] = field(default_factory=list)
    eval_rounds: List[int] = field(default_factory=list)
    sampling_hz: float = 0.0
    update_hz: float = 0.0            # update frequency (steps/s)
    update_frame_hz: float = 0.0      # update frame rate (steps/s * batch)
    transfer_stats: Dict[str, float] = field(default_factory=dict)
    solved_time: Optional[float] = None
    wall_s: float = 0.0               # timed window (post-warmup wall time)
    warmup_frames: int = 0            # frames sampled during this warmup
    eval_blocked_s: float = 0.0       # train-thread time lost to eval/viz
    runtime_stats: Dict[str, Any] = field(default_factory=dict)
    _lock: Any = field(default_factory=threading.Lock, repr=False,
                       compare=False)

    def record_eval(self, t, ret, frames, steps, round_i=None):
        with self._lock:
            if round_i is None:
                round_i = (self.eval_rounds[-1] + 1 if self.eval_rounds
                           else 0)
            i = bisect.bisect_right(self.eval_rounds, round_i)
            self.eval_rounds.insert(i, round_i)
            self.times.insert(i, t)
            self.eval_returns.insert(i, ret)
            self.env_frames.insert(i, frames)
            self.update_steps.insert(i, steps)


def _window_hits(round_i: int, window: int, every: int) -> bool:
    """True iff the round window [round_i, round_i + window) contains a
    multiple of ``every`` — the fused-dispatch generalization of
    ``round_i % every == 0`` (to which it reduces at window == 1)."""
    if not every:
        return False
    return (round_i + window - 1) // every > (round_i - 1) // every


def _round_generator(seed: int, round_i: int, device) -> torch.Generator:
    """A generator of its own for round ``round_i`` of the stream
    ``seed``: safe to make on any thread, and the same numbers whichever
    rounds came before."""
    s = np.random.SeedSequence((seed, round_i)).generate_state(1, np.uint64)
    # tracelint: allow[host-transfer] -- a numpy seed, not a tensor
    return torch.Generator(device=device).manual_seed(int(s[0]))


class Draws:
    """The trainer's random numbers: one Philox generator on its device
    for training, and per-round generators for eval and viz (so eval
    gating never shifts the training stream, and a round's eval does not
    depend on which earlier rounds were scored)."""

    def __init__(self, env: env_base.Env, train_seed: int, eval_seed: int,
                 device, viz_seed: int = 0):
        self.env = env
        self.device = torch.device(device)
        self.gen = torch.Generator(device=device).manual_seed(train_seed)
        self.eval_seed, self.viz_seed = eval_seed, viz_seed

    def sampler_step(self, num_envs: int, act_dim: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One env step's draws: the actor noise (num_envs, act_dim) and
        the reset draws for the envs whose episode ends."""
        eps = torch.randn((num_envs, act_dim), generator=self.gen,
                          device=self.gen.device)
        return eps, self.env.reset_draws(num_envs, self.gen)

    def _noises(self, noises: int, batch_size: int, act_dim: int
                ) -> Tuple[torch.Tensor, ...]:
        if not noises:
            return ()
        return torch.randn((noises, batch_size, act_dim), generator=self.gen,
                           device=self.gen.device).unbind(0)

    def update(self, replay: rb.ReplayState, batch_size: int, act_dim: int,
               noises: int = 2) -> Tuple[torch.Tensor, ...]:
        """One update's draws: uniform replay indices, then ``noises``
        standard-normal (batch_size, act_dim) action noises (the
        algorithm's ``UPDATE_NOISES``; SAC's two: critic target, actor
        loss)."""
        idx = rb.uniform_indices(replay, batch_size, self.gen)
        return (idx,) + self._noises(noises, batch_size, act_dim)

    def per_update(self, capacity: int, batch_size: int, act_dim: int,
                   noises: int = 2) -> Tuple[torch.Tensor, ...]:
        """One PER update's draws: the Gumbel field (capacity,) over the
        pool's slots, ``-log(-log(u))`` for u uniform on [1e-12, 1), then
        ``noises`` standard-normal action noises."""
        u = torch.rand((capacity,), generator=self.gen,
                       device=self.gen.device).clamp_(min=1e-12)
        return ((-torch.log(-torch.log(u)),)
                + self._noises(noises, batch_size, act_dim))

    def eval_reset(self, n: int, round_i: int) -> Dict[str, torch.Tensor]:
        """The reset draws of round ``round_i``'s ``n`` eval episodes."""
        return self.env.reset_draws(
            n, _round_generator(self.eval_seed, round_i, self.device))

    def viz_reset(self, round_i: int) -> Dict[str, torch.Tensor]:
        """The reset draws of round ``round_i``'s one viz episode."""
        return self.env.reset_draws(
            1, _round_generator(self.viz_seed, round_i, self.device))

    def get_state(self) -> torch.Tensor:
        """The training generator's state (a CPU uint8 tensor; on the card
        its seed and offset, which the host keeps, so reading it waits
        for nothing and matches the launches already enqueued). Eval and
        viz draw from per-round generators and carry no state."""
        return self.gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.gen.set_state(state)


class ActorSnapshot(NamedTuple):
    """Actor parameters a consumer may own, and the CUDA event recorded
    on the producing stream once they are written (``None``: made on the
    consumer's own stream, or on the CPU)."""
    params: Dict[str, Any]
    ready: Optional[Any] = None


class SpreezeTrainer:
    """End-to-end Spreeze training on a batched PyTorch env."""

    def __init__(self, cfg: SpreezeConfig, draws=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.layout = None          # core.model_parallel.MeshLayout
        self.rules = None           # its distributed.sharding.MeshRules
        if cfg.mesh is not None:
            self.layout = mp.MeshLayout(cfg.mesh, cfg.placement)
            self.rules = self.layout.rules
            if self.layout.primary.type != self.device.type:
                raise ValueError(
                    f"the mesh's primary device {self.layout.primary} is "
                    f"not a {self.device.type!r} device (device="
                    f"{cfg.device!r})")
            self.device = self.layout.primary
        exact_float32(self.device)
        self.env = env_base.make(cfg.env_name)
        spec = self.env.spec
        self.algo = get_algo(cfg.algo)
        self.hp = cfg.hp
        if cfg.prioritized and cfg.transfer != "shared":
            raise ValueError("prioritized replay requires the "
                             "shared-memory transfer path")
        if cfg.transfer == "queue" and cfg.queue_size > cfg.replay_capacity:
            # a drain holds up to queue_size rows, and one ring write
            # takes at most capacity rows
            raise ValueError(f"queue_size {cfg.queue_size} exceeds "
                             f"replay_capacity {cfg.replay_capacity}")
        if cfg.weight_sync not in ("live", "ssd"):
            raise ValueError(f"unknown weight_sync {cfg.weight_sync!r}")
        fusable = cfg.transfer == "shared" and not cfg.sync_mode
        self.use_fused = fusable if cfg.fused is None else cfg.fused
        if self.use_fused and not fusable:
            raise ValueError("fused megastep requires the shared-memory "
                             "transfer path and async mode (sync_mode and "
                             "the queue baseline stay on the eager loop)")
        if cfg.overlap_eval and not self.use_fused:
            raise ValueError("overlap_eval snapshots are emitted by the "
                             "fused megastep; the eager loop's live "
                             "weights already overlap")
        if cfg.async_eval and cfg.sync_mode:
            raise ValueError("async_eval runs eval/viz on background "
                             "workers; sync_mode is the Fig. 4a inline "
                             "ablation — pick one")
        if cfg.eval_workers < 1 or cfg.viz_workers < 1:
            raise ValueError("eval_workers / viz_workers must be >= 1")
        # auto: async host runtime unless the sync ablation asked to block
        self.use_async_eval = ((not cfg.sync_mode) if cfg.async_eval is None
                               else bool(cfg.async_eval))
        init_seed, train_seed, eval_seed, viz_seed = (
            # tracelint: allow[host-transfer] -- numpy seeds, not tensors
            int(s) for s in np.random.SeedSequence(cfg.seed).generate_state(4))
        gen = torch.Generator(device=self.device).manual_seed(init_seed)
        self.draws = draws if draws is not None else Draws(
            self.env, train_seed, eval_seed, self.device, viz_seed)
        self.state = self.algo.init_state(gen, spec.obs_dim, spec.act_dim,
                                          self.hp, self.device)
        specs = rb.trainer_specs(spec.obs_dim, spec.act_dim)
        if cfg.prioritized:
            self.replay = per.init_prioritized(cfg.replay_capacity, specs,
                                               self.device)
            add = per.add_batch
        else:
            self.replay = rb.init_replay(cfg.replay_capacity, specs,
                                         self.device)
            add = rb.add_batch
        if self.layout is not None:
            self._check_mesh()
            self.state = mp.place_state(self.state, self.layout)
            self.replay = mp.place_replay(self.replay, self.layout)
            add = functools.partial(add, rules=self.rules)
        # (prioritized replay is refused off the shared transfer above)
        self.transfer = make_transfer(cfg.transfer, cfg.queue_size,
                                      add_fn=add, device=self.device)
        self.env_states = self.env.reset_batch(cfg.num_envs, gen)
        self._act = self.algo.make_act(self.hp)
        self._act_det = self.algo.make_act(self.hp, deterministic=True)
        self._update = self._make_update()
        self._streams = threading.local()    # a worker thread's stream
        self._ssd_dir = None
        self._ssd_cache = None
        self._fault_clock: Optional[faults.FaultClock] = None
        self._guard_q: collections.deque = collections.deque()
        self._rollbacks = 0
        self.total_frames = 0
        self.total_updates = 0
        self.last_metrics = None     # stacked (R,) tensors per megastep

    def _check_mesh(self):
        """The reference's refusals of a mesh config, all at construction
        (the port has no single-device path to fall back to); reads the
        whole state before it is placed."""
        cfg, layout = self.cfg, self.layout
        if not self.use_fused:
            raise ValueError("the multi-device megastep needs the fused "
                             "path (shared transfer, async mode)")
        n_q = tree_leaves(self.state.q)[0].shape[0]
        if n_q % layout.ac_parts:
            raise ValueError(f"ac axis size {layout.ac_parts} must divide "
                             f"the Q ensemble size {n_q} (algo "
                             f"{cfg.algo!r})")
        groups = layout.groups
        if cfg.replay_capacity % groups:
            raise ValueError(f"replay_capacity {cfg.replay_capacity} must "
                             f"be divisible by the {groups} ring shards")
        if cfg.batch_size % groups:
            raise ValueError(f"batch_size {cfg.batch_size} must be "
                             f"divisible by the {groups} ring shards")
        if cfg.prioritized and cfg.batch_size > cfg.replay_capacity // groups:
            # each group emits batch_size top-k candidates from its shard
            raise ValueError(
                f"prioritized batch_size {cfg.batch_size} exceeds the "
                f"per-group ring shard ({cfg.replay_capacity} // {groups} "
                f"rows): group-local PER selection needs batch_size <= "
                f"capacity // groups")

    def _make_update(self):
        """The algorithm's update for this trainer's hyperparameters; on a
        mesh run once a batch group (``model_parallel.MeshUpdate``)."""
        spec = self.env.spec
        update = self.algo.make_update_step(self.hp, spec.obs_dim,
                                            spec.act_dim)
        if self.layout is None:
            return update
        return mp.MeshUpdate(update, self.layout)

    # ------------------------------------------------------------------ #
    # the "processes" of one round
    # ------------------------------------------------------------------ #
    # hlolint: entrypoint[sampler_chunk]
    @trace.spanned("sampler_chunk")
    @torch.no_grad()
    def sampler_chunk(self, actor, states):
        """``chunk_len`` vectorized env steps under the live policy.
        Returns (states', experience rows (T*N, ...), mean raw reward)."""
        cfg, env = self.cfg, self.env
        steps = []
        for _ in range(cfg.chunk_len):
            obs = env.observe(states)
            eps, reset_draws = self.draws.sampler_step(cfg.num_envs,
                                                       env.spec.act_dim)
            a = self._act(actor, obs, eps)
            states, nobs, rew, done = env.autoreset_step(states, a,
                                                         reset_draws)
            steps.append({"obs": obs, "act": a, "rew": rew,
                          "next_obs": nobs, "done": done.to(torch.float32)})
        exps = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        # metric from the RAW per-step rewards: after nstep_chunk the rows
        # carry n-step accumulated returns
        mrew = exps["rew"].mean()
        exps = nstep_chunk(exps, cfg.nstep, self.hp.gamma)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in exps.items()}
        return states, flat, mrew

    # hlolint: entrypoint[update_round]
    @trace.spanned("update_round")
    def update_round(self, state, replay):
        """K updates on freshly sampled batches; returns (state, mean
        critic loss). Under PER each update samples, takes the weighted
        step and re-prioritises the drawn rows in ``replay``, in place."""
        cfg = self.cfg
        act_dim = self.env.spec.act_dim
        noises = self.algo.UPDATE_NOISES
        losses = []
        for _ in range(cfg.updates_per_round):
            if cfg.prioritized:
                gumbel, *eps = self.draws.per_update(
                    cfg.replay_capacity, cfg.batch_size, act_dim, noises)
                batch, idx, w = per.sample(replay, gumbel, cfg.batch_size,
                                           alpha=cfg.per_alpha,
                                           beta=cfg.per_beta,
                                           rules=self.rules)
                batch["weight"] = w
                state, metrics = self._update(state, batch, *eps)
                per.update_priorities(replay, idx, metrics["td_abs"],
                                      rules=self.rules)
            else:
                idx, *eps = self.draws.update(replay, cfg.batch_size,
                                              act_dim, noises)
                state, metrics = self._update(
                    state, rb.sample(replay, idx, rules=self.rules), *eps)
            losses.append(metrics["critic_loss"])
        return state, torch.stack(losses).mean()

    # hlolint: entrypoint[megastep, megastep_per, megastep_sharded, megastep_sharded_per]
    def megastep(self, rounds: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
        """``rounds`` (default ``rounds_per_dispatch``) iterations of
        {sampler chunk -> ring write -> K updates}, in place on the
        trainer's state, ring and env states. Returns the stacked (R,)
        per-round metrics and ``carry_finite`` (a bool scalar: the actor
        and the metrics are finite), left on the device; under
        ``overlap_eval`` also ``actor_snapshot``, a copy of the actor made
        at its end."""
        with trace.first("megastep"):
            rews, closs = [], []
            for _ in range(rounds or self.cfg.rounds_per_dispatch):
                self.env_states, flat, mrew = self.sampler_chunk(
                    self.state.actor, self.env_states)
                self.replay = self.transfer.push(self.replay, flat)
                self.state, cl = self.update_round(self.state, self.replay)
                rews.append(mrew)
                closs.append(cl)
            self.last_metrics = {"mean_rew": torch.stack(rews),
                                 "critic_loss": torch.stack(closs)}
            # the finite guard: a NaN anywhere in the Q / env path reaches
            # the round metrics within the megastep
            self.last_metrics["carry_finite"] = faults.tree_finite(
                (self.state.actor, self.last_metrics))
            if self.cfg.overlap_eval:
                self.last_metrics["actor_snapshot"] = self._clone_actor()
        return self.last_metrics

    def eager_round(self):
        """One round of the eager loop (Fig. 4a's handoffs): sampler
        chunk, ``transfer.push``, ``transfer.flush``, update round; under
        ``sync_mode`` the device is synchronised after the push and after
        the update round. Under ``sanitize`` each half runs in its own
        scope, the synchronisations outside them."""
        cfg = self.cfg
        with self._sanitize_scope():
            self.env_states, exp, _ = self.sampler_chunk(self.state.actor,
                                                         self.env_states)
            self.replay = self.transfer.push(self.replay, exp)
        self.total_frames += cfg.num_envs * cfg.chunk_len
        if cfg.sync_mode:
            self._sync()                 # Fig. 4a: the sampler's handoff
        with self._sanitize_scope():
            self.replay = self.transfer.flush(self.replay)
            self.state, _ = self.update_round(self.state, self.replay)
        self.total_updates += cfg.updates_per_round
        if cfg.sync_mode:
            self._sync()                 # Fig. 4a: the updater's handoff

    # ------------------------------------------------------------------ #
    # the eval / viz "processes"
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def evaluate(self, actor, round_i: int) -> float:
        """Mean return of ``eval_episodes`` deterministic episodes from
        round ``round_i``'s reset draws, on the current stream (one host
        read at the end, which waits for that stream only). Every episode
        runs ``episode_len`` steps; ``done`` is ignored, as in the
        reference."""
        env = self.env
        s = env.reset(self.draws.eval_reset(self.cfg.eval_episodes,
                                            round_i))
        total = torch.zeros(self.cfg.eval_episodes, device=self.device)
        for _ in range(env.spec.episode_len):
            s, _, r, _ = env.step(s, self._act_det(actor, env.observe(s),
                                                   None))
            total = total + r
        # tracelint: allow[host-transfer] -- eval's one read, on the eval worker's own stream
        return float(total.mean())

    @torch.no_grad()
    def viz_episode(self, actor, round_i: int):
        """One deterministic rollout recording (obs, act, rew), each
        (episode_len, ...): the paper's visualization process, without
        the GUI."""
        env = self.env
        s = env.reset(self.draws.viz_reset(round_i))
        obs, act, rew = [], [], []
        for _ in range(env.spec.episode_len):
            o = env.observe(s)
            a = self._act_det(actor, o, None)
            s, _, r, _ = env.step(s, a)
            obs.append(o[0])
            act.append(a[0])
            rew.append(r[0])
        return torch.stack(obs), torch.stack(act), torch.stack(rew)

    def _viz_dump(self, actor, round_i: int) -> None:
        """Run the viz rollout and write it to ``viz_dir`` as
        ``traj_<round>.npz``."""
        obs, act, rew = self.viz_episode(actor, round_i)
        if self.cfg.viz_dir:
            os.makedirs(self.cfg.viz_dir, exist_ok=True)
            # tracelint: allow[host-transfer] -- the viz worker writes its rollout to disk
            arrays = {k: v.cpu().numpy() for k, v in zip(("obs", "act", "rew"), (obs, act, rew))}
            np.savez(os.path.join(self.cfg.viz_dir,
                                  f"traj_{round_i:06d}.npz"), **arrays)

    def _sync(self):
        if self.device.type == "cuda":
            devices = ([self.device] if self.layout is None
                       else self.layout.mesh.distinct_devices)
            for dev in devices:
                # tracelint: allow[host-transfer] -- sync_mode's handoff waits and the run's barriers, by design
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------ #
    # weight sync to the eval/viz "processes"
    # ------------------------------------------------------------------ #
    def _clone_actor(self) -> ActorSnapshot:
        """A copy of the actor, enqueued on the current stream before the
        next update writes the parameters in place, and the event that
        marks it done."""
        params = tree_map(torch.clone, self.state.actor)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return ActorSnapshot(params, ready)

    def _snapshot_actor(self) -> ActorSnapshot:
        """The snapshot the async workers own: the megastep's
        ``overlap_eval`` copy when there is one, else a fresh clone."""
        if (self.cfg.overlap_eval and self.last_metrics is not None
                and "actor_snapshot" in self.last_metrics):
            return self.last_metrics["actor_snapshot"]
        return self._clone_actor()

    @contextlib.contextmanager
    def _consumer_stream(self, snap: ActorSnapshot):
        """Run a consumer of ``snap`` on the calling thread's own CUDA
        stream: it waits for the snapshot's event, and the snapshot's
        memory is marked in use on that stream, so the caching allocator
        cannot hand it to the train stream while the consumer still
        reads it. A snapshot without an event runs on the current
        stream."""
        if snap.ready is None:
            yield snap.params
            return
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            stream.wait_event(snap.ready)
            for t in tree_leaves(snap.params):
                if torch.is_tensor(t) and t.is_cuda:
                    t.record_stream(stream)
            yield snap.params

    def _ssd_materialize(self, snap: ActorSnapshot,
                         round_i: Optional[int] = None) -> ActorSnapshot:
        """The paper's SSD weight channel: an atomic write-then-rename
        ``.npz`` (copied to the host after the snapshot's event), then
        read back onto the card. Consumers never see a torn file. The
        fault plan's SSD failure fires here, by round."""
        if self._fault_clock is not None and round_i is not None:
            self._fault_clock.ssd_oserror(round_i)
        if self._ssd_dir is None:
            self._ssd_dir = tempfile.TemporaryDirectory(prefix="spreeze_ssd_")
        path = os.path.join(self._ssd_dir.name, "actor.npz")
        with self._host_side(), self._consumer_stream(snap) as params:
            checkpoint.save(path, params)
            params, _ = checkpoint.restore(path, params)
            ready = None
            if snap.ready is not None:
                ready = torch.cuda.Event()
                ready.record()
        return ActorSnapshot(params, ready)

    def _actor_for_eval(self, round_i: int):
        """The inline (sync_mode / ``async_eval=False``) weight sync, on
        the train stream: the live actor (or the ``overlap_eval`` copy),
        or under ``weight_sync="ssd"`` its save and restore, once a round
        (viz and eval of one round share it)."""
        actor = self.state.actor
        if (self.cfg.overlap_eval and self.last_metrics is not None
                and "actor_snapshot" in self.last_metrics):
            actor = self.last_metrics["actor_snapshot"].params
        if self.cfg.weight_sync == "live":
            return actor
        if self._ssd_cache is not None and self._ssd_cache[0] == round_i:
            return self._ssd_cache[1]
        actor = self._ssd_materialize(ActorSnapshot(actor)).params
        self._ssd_cache = (round_i, actor)
        return actor

    def _eval_worker_fn(self, snap: ActorSnapshot, round_i: int) -> float:
        """Body of the async eval workers: ``snap``'s eval on the
        worker's own stream (its host read waits for that stream only).
        The fault plan's eval failure and hang fire here, by round."""
        if self._fault_clock is not None:
            self._fault_clock.eval_fault(round_i)
        with self._host_side(), self._consumer_stream(snap) as actor:
            return self.evaluate(actor, round_i)

    def _viz_worker_fn(self, snap: ActorSnapshot, round_key: int,
                       round_i: int) -> None:
        with self._host_side(), self._consumer_stream(snap) as actor:
            self._viz_dump(actor, round_i)

    def _write_state(self, item: resume_lib.Published) -> Optional[str]:
        """Body of the snapshot worker: write a published bundle once its
        event has completed, on the worker's own stream; a bundle with a
        non-finite value is skipped."""
        cfg = self.cfg
        with self._host_side(), self._consumer_stream(
                ActorSnapshot(item.bundle, item.ready)) as bundle:
            return resume_lib.write_bundle(
                cfg.snapshot_dir, (bundle, item.meta),
                keep=cfg.keep_snapshots, require_finite=True)

    def _make_runtime(self, hist, target_return, log_cb,
                      snapshots: bool = False):
        """The host async runtime for one ``train()`` call: eval/viz/SSD
        (and full-state snapshot) workers behind latest-wins mailboxes
        (core.runtime), supervised per the config."""
        cfg = self.cfg
        return rt.HostRuntime(
            eval_fn=self._eval_worker_fn,
            viz_fn=self._viz_worker_fn if cfg.viz_every_rounds else None,
            hist=hist,
            materialize_fn=(self._ssd_materialize
                            if cfg.weight_sync == "ssd" else None),
            state_fn=self._write_state if snapshots else None,
            eval_workers=cfg.eval_workers, viz_workers=cfg.viz_workers,
            target_return=target_return, log_cb=log_cb,
            policy=rt.SupervisorPolicy(
                supervise=cfg.supervise,
                max_restarts=cfg.worker_retry_budget,
                heartbeat_timeout_s=cfg.worker_heartbeat_s))

    # ------------------------------------------------------------------ #
    # the training loop
    # ------------------------------------------------------------------ #
    def _warmup(self):
        """Fill the pool with experience from the initial policy, through
        the transfer, with a forced flush at the end."""
        cfg = self.cfg
        while self.total_frames < cfg.warmup_frames:
            self.env_states, exp, _ = self.sampler_chunk(self.state.actor,
                                                         self.env_states)
            self.replay = self.transfer.push(self.replay, exp)
            self.replay = self.transfer.flush(self.replay)
            self.total_frames += cfg.num_envs * cfg.chunk_len
        self.replay = self.transfer.flush(self.replay, force=True)
        self._sync()     # barrier before the timed window opens

    # ------------------------------------------------------------------ #
    # sanitize, the finite guard and rollback
    # ------------------------------------------------------------------ #
    def _host_side(self):
        """A worker body of a sanitized trainer holds the gate, so its host
        reads never meet a dispatch's "error" mode."""
        return _SYNC_GATE if self.cfg.sanitize else contextlib.nullcontext()

    def _sanitize_scope(self):
        """Guard one hot-loop dispatch when ``cfg.sanitize``: on the card
        the sync debug mode is "error" inside it, so any operation that
        waits for the device raises; on leaving (the mode restored) the
        carry is checked and a non-finite value raises
        ``FloatingPointError``. The scope is built in an ``ExitStack``, so
        a failure partway through entering unwinds what was entered.
        Eval, viz and the snapshot writer (host-side by design) stay
        outside it."""
        if not self.cfg.sanitize:
            return contextlib.nullcontext()

        def check_finite(exc_type, exc, tb):
            carry = (self.state, self.replay, self.env_states,
                     self.last_metrics)
            if exc_type is None and not faults.finite_guard(carry):
                raise FloatingPointError(
                    "a sanitized dispatch left a non-finite value in the "
                    "trainer's carry")
            return False

        with contextlib.ExitStack() as stack:
            stack.enter_context(_SYNC_GATE)
            stack.push(check_finite)
            stack.enter_context(sync_debug_mode(self.device, "error"))
            return stack.pop_all()

    def _guard_entry(self, round_i: int, flag: torch.Tensor):
        """(round, host flag, event): on the card the flag is copied to
        pinned host memory after the megastep's launches and an event is
        recorded after the copy, so the flag is read only once the event
        has completed and the poll never waits. On the CPU the flag is
        ready at once."""
        if not flag.is_cuda:
            return round_i, flag, None
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return round_i, host, ready

    def _poll_guard(self, blocking: bool = False) -> Optional[int]:
        """The oldest round whose ``carry_finite`` came back False, or
        None. A flag is inspected only once its event has completed, so
        the poll never waits for the device; ``blocking`` drains the
        queue at the end of a run."""
        q = self._guard_q
        while q:
            round_i, flag, ready = q[0]
            if ready is not None and not ready.query():
                if not blocking:
                    return None
                # tracelint: allow[host-transfer] -- the end-of-run drain, outside the timed loop
                ready.synchronize()
            q.popleft()
            # tracelint: allow[host-transfer] -- a pinned host copy whose event has completed: no wait
            if not bool(flag):
                return round_i
        return None

    def _rollback(self, runtime, hist, bad_round: int) -> int:
        """A non-finite carry: back the learning rate off, rebuild the
        update (it closes over the rate), restore the latest snapshot
        (state, ring, env states, draws, counters, history) and return
        the round to go on from. Raises ``FiniteGuardError`` when there
        is nothing to roll back to or the budget is spent."""
        cfg = self.cfg
        self._rollbacks += 1
        if self._rollbacks > cfg.max_rollbacks:
            raise faults.FiniteGuardError(
                f"megastep carry went non-finite at round {bad_round} "
                f"and the rollback budget ({cfg.max_rollbacks}) is spent")
        if runtime is not None:
            # land any snapshot write or eval in flight before picking the
            # target (rollback is off the hot path)
            runtime.drain()
        path = (resume_lib.latest(cfg.snapshot_dir) if cfg.snapshot_dir
                else None)
        if path is None:
            raise faults.FiniteGuardError(
                f"megastep carry went non-finite at round {bad_round} "
                f"and no snapshot exists to roll back to (set "
                f"snapshot_dir to enable rollback)")
        self.hp = dataclasses.replace(
            self.hp, lr=self.hp.lr * cfg.rollback_lr_backoff)
        self._update = self._make_update()
        meta = resume_lib.restore_trainer(self, path)
        resume_lib.hist_restore(hist, meta.get("hist") or {})
        self._guard_q.clear()
        self._ssd_cache = None
        warnings.warn(
            f"non-finite megastep carry at round {bad_round}: rolled "
            f"back to snapshot round {meta['round_i']} with lr backed "
            f"off to {self.hp.lr:g} (rollback {self._rollbacks}/"
            f"{cfg.max_rollbacks})")
        return int(meta["round_i"])  # tracelint: allow[host-transfer] -- a JSON field of the snapshot's meta

    def train(self, *, max_seconds: float = 60.0, max_frames: int = 10**9,
              target_return: Optional[float] = None,
              log_cb: Optional[Callable] = None,
              resume_from: Optional[str] = None) -> TrainHistory:
        """Warm up, then run megasteps (or eager rounds) until
        ``max_seconds`` or ``max_frames`` (checked before each) or until
        an eval reaches ``target_return``. When a round window hits
        ``eval_every_rounds`` (``viz_every_rounds``) the actor is
        published to the async runtime, or evaluated inline on the train
        thread under ``sync_mode`` / ``async_eval=False``; when it hits
        ``snapshot_every_rounds`` a bundle of the whole state is
        published to the snapshot worker (or written inline).
        ``resume_from`` continues from a snapshot bundle, which covers
        the warmup."""
        cfg = self.cfg
        hist = TrainHistory()
        frames_per_round = cfg.num_envs * cfg.chunk_len
        self._fault_clock = (faults.FaultClock(cfg.fault_plan)
                             if cfg.fault_plan is not None else None)
        self._rollbacks = 0
        start_round = 0
        if resume_from is not None:
            meta = resume_lib.restore_trainer(self, resume_from)
            start_round = int(meta["round_i"])  # tracelint: allow[host-transfer] -- a JSON field of the snapshot's meta
            resume_lib.hist_restore(hist, meta.get("hist") or {})
        pre_warmup = self.total_frames
        self._warmup()
        if resume_from is None:
            hist.warmup_frames = self.total_frames - pre_warmup
        frames0, updates0 = self.total_frames, self.total_updates
        # round counters restart every train() call: a same-numbered
        # round from a previous run must not serve its cached SSD actor
        self._ssd_cache = None
        window = cfg.rounds_per_dispatch if self.use_fused else 1
        self._guard_q.clear()    # carry_finite flags, polled without a wait
        want_snaps = bool(cfg.snapshot_dir) and cfg.snapshot_every_rounds > 0
        last_snap_t = float("-inf")     # the first eligible window snapshots
        runtime = None
        if self.use_async_eval and (cfg.eval_every_rounds
                                    or cfg.viz_every_rounds or want_snaps):
            runtime = self._make_runtime(hist, target_return, log_cb,
                                         snapshots=want_snaps)

        t0 = time.perf_counter()
        round_i = start_round
        solved_at = None
        try:
            while True:
                if (time.perf_counter() - t0 >= max_seconds
                        or self.total_frames >= max_frames):
                    break
                if runtime is not None and runtime.solved.is_set():
                    solved_at = runtime.solved_time
                    break
                bad_round = self._poll_guard()
                if bad_round is not None:
                    round_i = self._rollback(runtime, hist, bad_round)
                    continue
                clock = self._fault_clock
                if clock is not None and clock.preempt(round_i):
                    # a simulated SIGTERM between megasteps: drain the
                    # runtime (every published eval lands, so the saved
                    # history is exact), snapshot, stop
                    if runtime is not None:
                        runtime.close()
                        hist.runtime_stats = runtime.stats()
                        runtime = None
                    path = (resume_lib.snapshot_now(self, hist, round_i)
                            if cfg.snapshot_dir else None)
                    raise faults.Preempted(
                        f"injected preemption at round {round_i} "
                        f"(snapshot: {path})",
                        snapshot_path=path, round_i=round_i)
                if clock is not None and clock.nan(round_i):
                    self.state = mp.replace_actor(
                        self.state, faults.poison_actor(self.state.actor),
                        self.layout)
                if self.use_fused:
                    with self._sanitize_scope():
                        self.megastep()
                    self.total_frames += frames_per_round * window
                    self.total_updates += cfg.updates_per_round * window
                    self._guard_q.append(self._guard_entry(
                        round_i, self.last_metrics["carry_finite"]))
                else:
                    self.eager_round()
                want_viz = _window_hits(round_i, window,
                                        cfg.viz_every_rounds)
                want_eval = _window_hits(round_i, window,
                                         cfg.eval_every_rounds)
                if want_viz or want_eval:
                    tb = time.perf_counter()
                    if runtime is not None:
                        # async: publish the snapshot and go on; the
                        # workers take it on their own streams
                        runtime.publish(rt.Snapshot(
                            round_i=round_i, actor=self._snapshot_actor(),
                            eval_key=round_i, viz_key=round_i,
                            t=tb - t0, frames=self.total_frames,
                            steps=self.total_updates, want_eval=want_eval,
                            want_viz=want_viz))
                    else:
                        # inline (the sync ablation): block the train
                        # thread
                        if want_viz:
                            self._viz_dump(self._actor_for_eval(round_i),
                                           round_i)
                        if want_eval:
                            ret = self.evaluate(
                                self._actor_for_eval(round_i), round_i)
                            t = time.perf_counter() - t0
                            hist.record_eval(t, ret, self.total_frames,
                                             self.total_updates,
                                             round_i=round_i)
                            if log_cb:
                                log_cb(t, ret, self.total_frames,
                                       self.total_updates)
                            if (target_return is not None
                                    and ret >= target_return):
                                solved_at = t
                                hist.eval_blocked_s += (
                                    time.perf_counter() - tb)
                                break
                    hist.eval_blocked_s += time.perf_counter() - tb
                # periodic full-state snapshot; its meta records the NEXT
                # round, so a resumed run starts where this one stopped
                if (want_snaps and _window_hits(round_i, window,
                                                cfg.snapshot_every_rounds)
                        and (time.perf_counter() - last_snap_t
                             >= cfg.snapshot_min_interval_s)):
                    if runtime is not None:
                        # clone only when the writer will take it: a
                        # bundle replaced latest-wins still costs the copy
                        if runtime.state_slot_free():
                            runtime.publish_state(resume_lib.publishable(
                                self, hist, round_i + window))
                            last_snap_t = time.perf_counter()
                    else:
                        # inline: the write waits for the device anyway;
                        # a poisoned bundle is skipped, never a target
                        resume_lib.write_bundle(
                            cfg.snapshot_dir,
                            (resume_lib.bundle_from(self),
                             resume_lib.build_meta(self, hist,
                                                   round_i + window)),
                            keep=cfg.keep_snapshots, require_finite=True)
                        last_snap_t = time.perf_counter()
                round_i += window
            self._sync()     # end-of-run barrier closing the timed window
            # a run whose last megasteps went non-finite fails loudly
            bad_round = self._poll_guard(blocking=True)
            if bad_round is not None:
                raise faults.FiniteGuardError(
                    f"megastep carry went non-finite at round {bad_round} "
                    f"(detected at end of run)")
            wall = time.perf_counter() - t0
        finally:
            if runtime is not None:
                # drained outside the timed window: the last published
                # snapshot is always scored before train() returns
                runtime.close()
        if runtime is not None:
            if solved_at is None and runtime.solved.is_set():
                solved_at = runtime.solved_time
            hist.runtime_stats = runtime.stats()
            degraded = hist.runtime_stats.get("degraded") or []
            if degraded:
                warnings.warn(
                    f"training finished degraded: worker(s) {degraded} "
                    f"exhausted their restart budget and were dropped "
                    f"(restarts={hist.runtime_stats['worker_restarts']}, "
                    f"dropped={hist.runtime_stats['degraded_dropped']})")
        hist.runtime_stats["rollbacks"] = self._rollbacks
        hist.wall_s = wall
        hist.sampling_hz = (self.total_frames - frames0) / wall
        hist.update_hz = (self.total_updates - updates0) / wall
        hist.update_frame_hz = hist.update_hz * cfg.batch_size
        hist.transfer_stats = self.transfer.stats()
        hist.solved_time = solved_at
        return hist
