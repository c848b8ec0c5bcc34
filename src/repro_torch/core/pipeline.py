"""The Spreeze trainer: sampler chunk -> ring write -> K updates, fused
into megasteps of R rounds. Counterpart of the single-device path of
``repro/core/pipeline.py``, with SAC, TD3 or DDPG and uniform or
prioritized replay.

One round steps ``num_envs`` pendulums for ``chunk_len`` steps under the
actor, applies the n-step transform, writes the rows into the
device-resident replay ring (the ``ring_write`` kernel, one launch per
field) and runs ``updates_per_round`` updates, each on a batch that
the ``ring_gather`` kernel reads (one launch per field). With
``prioritized=True`` the write also tags the new rows with the max
priority (one more ``ring_write``), and each update draws its batch with
the ``per_topk`` kernel, gathers the drawn rows' priority mass (one more
``ring_gather``), weighs the critic loss by importance and writes the
new priorities back with ``priority_scatter``. ``megastep`` runs
``rounds_per_dispatch`` rounds in one call. It runs eagerly: the
state, the ring and the optimizer moments are updated in place (the
analogue of the JAX megastep's buffer donation), and nothing in a
megastep reads a tensor back to the host.

Randomness comes from a draw source (``Draws`` by default: Philox
generators on the trainer's device). A caller may pass another with the
same methods, for example one that replays another implementation's
draws.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.transfer import SharedTransfer
from repro_torch.envs import base as env_base
from repro_torch.replay import buffer as rb
from repro_torch.replay import prioritized as per
from repro_torch.replay.nstep import nstep_chunk
from repro_torch.rl.base import AlgoHP, get_algo


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
    prioritized: bool = False     # APE-X-style PER on the shared pool
    per_alpha: float = 0.6
    per_beta: float = 0.4
    nstep: int = 1                # n-step returns (APE-X uses 3)
    eval_every_rounds: int = 50   # 0 = off
    eval_episodes: int = 4
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
    are reported separately in ``warmup_frames``."""
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
    eval_blocked_s: float = 0.0       # train-loop time spent in eval

    def record_eval(self, t, ret, frames, steps, round_i):
        """Append one eval result (eval runs inline, in round order)."""
        self.eval_rounds.append(round_i)
        self.times.append(t)
        self.eval_returns.append(ret)
        self.env_frames.append(frames)
        self.update_steps.append(steps)


def _window_hits(round_i: int, window: int, every: int) -> bool:
    """True iff the round window [round_i, round_i + window) contains a
    multiple of ``every`` — the fused-dispatch generalization of
    ``round_i % every == 0`` (to which it reduces at window == 1)."""
    if not every:
        return False
    return (round_i + window - 1) // every > (round_i - 1) // every


class Draws:
    """The trainer's random numbers, from two Philox generators on its
    device: one for training, one for eval (so eval gating never shifts
    the training stream)."""

    def __init__(self, env: env_base.Env, train_seed: int, eval_seed: int,
                 device):
        self.env = env
        self.gen = torch.Generator(device=device).manual_seed(train_seed)
        self.eval_gen = torch.Generator(device=device).manual_seed(eval_seed)

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

    def eval_reset(self, n: int) -> Dict[str, torch.Tensor]:
        return self.env.reset_draws(n, self.eval_gen)


class SpreezeTrainer:
    """End-to-end Spreeze training on a batched PyTorch env."""

    def __init__(self, cfg: SpreezeConfig, draws=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            # the reference is float32 end to end: no TF32 products
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.env = env_base.make(cfg.env_name)
        spec = self.env.spec
        self.algo = get_algo(cfg.algo)
        self.hp = cfg.hp
        init_seed, train_seed, eval_seed = (
            int(s) for s in np.random.SeedSequence(cfg.seed).generate_state(3))
        gen = torch.Generator(device=self.device).manual_seed(init_seed)
        self.draws = draws if draws is not None else Draws(
            self.env, train_seed, eval_seed, self.device)
        self.state = self.algo.init_state(gen, spec.obs_dim, spec.act_dim,
                                          self.hp, self.device)
        specs = rb.trainer_specs(spec.obs_dim, spec.act_dim)
        if cfg.prioritized:
            self.replay = per.init_prioritized(cfg.replay_capacity, specs,
                                               self.device)
            self.transfer = SharedTransfer(add_fn=per.add_batch)
        else:
            self.replay = rb.init_replay(cfg.replay_capacity, specs,
                                         self.device)
            self.transfer = SharedTransfer()
        self.env_states = self.env.reset_batch(cfg.num_envs, gen)
        self._act = self.algo.make_act(self.hp)
        self._act_det = self.algo.make_act(self.hp, deterministic=True)
        self._update = self.algo.make_update_step(self.hp, spec.obs_dim,
                                                  spec.act_dim)
        self.total_frames = 0
        self.total_updates = 0
        self.last_metrics = None     # stacked (R,) tensors per megastep

    # ------------------------------------------------------------------ #
    # the "processes" of one round
    # ------------------------------------------------------------------ #
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
                                           beta=cfg.per_beta)
                batch["weight"] = w
                state, metrics = self._update(state, batch, *eps)
                per.update_priorities(replay, idx, metrics["td_abs"])
            else:
                idx, *eps = self.draws.update(replay, cfg.batch_size,
                                              act_dim, noises)
                state, metrics = self._update(state, rb.sample(replay, idx),
                                              *eps)
            losses.append(metrics["critic_loss"])
        return state, torch.stack(losses).mean()

    def megastep(self, rounds: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
        """``rounds`` (default ``rounds_per_dispatch``) iterations of
        {sampler chunk -> ring write -> K updates}, in place on the
        trainer's state, ring and env states. Returns the stacked (R,)
        per-round metrics, left on the device."""
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
        return self.last_metrics

    @torch.no_grad()
    def evaluate(self, actor) -> float:
        """Mean return of ``eval_episodes`` deterministic episodes (one
        host read at the end)."""
        env = self.env
        s = env.reset(self.draws.eval_reset(self.cfg.eval_episodes))
        total = torch.zeros(self.cfg.eval_episodes, device=self.device)
        for _ in range(env.spec.episode_len):
            s, _, r, _ = env.step(s, self._act_det(actor, env.observe(s),
                                                   None))
            total = total + r
        return float(total.mean())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # the training loop
    # ------------------------------------------------------------------ #
    def _warmup(self):
        """Fill the pool with experience from the initial policy."""
        cfg = self.cfg
        while self.total_frames < cfg.warmup_frames:
            self.env_states, exp, _ = self.sampler_chunk(self.state.actor,
                                                         self.env_states)
            self.replay = self.transfer.push(self.replay, exp)
            self.replay = self.transfer.flush(self.replay)
            self.total_frames += cfg.num_envs * cfg.chunk_len
        self._sync()     # barrier before the timed window opens

    def train(self, *, max_seconds: float = 60.0, max_frames: int = 10**9,
              target_return: Optional[float] = None,
              log_cb: Optional[Callable] = None) -> TrainHistory:
        """Warm up, then run megasteps until ``max_seconds`` or
        ``max_frames`` (checked before each megastep) or until an eval
        reaches ``target_return``. Eval runs inline on the live weights
        whenever a megastep's round window hits ``eval_every_rounds``."""
        cfg = self.cfg
        hist = TrainHistory()
        frames_per_round = cfg.num_envs * cfg.chunk_len
        pre_warmup = self.total_frames
        self._warmup()
        hist.warmup_frames = self.total_frames - pre_warmup
        frames0, updates0 = self.total_frames, self.total_updates
        window = cfg.rounds_per_dispatch

        t0 = time.perf_counter()
        round_i = 0
        solved_at = None
        while (time.perf_counter() - t0 < max_seconds
               and self.total_frames < max_frames):
            self.megastep()
            self.total_frames += frames_per_round * window
            self.total_updates += cfg.updates_per_round * window
            if _window_hits(round_i, window, cfg.eval_every_rounds):
                tb = time.perf_counter()
                ret = self.evaluate(self.state.actor)
                t = time.perf_counter() - t0
                hist.record_eval(t, ret, self.total_frames,
                                 self.total_updates, round_i=round_i)
                if log_cb:
                    log_cb(t, ret, self.total_frames, self.total_updates)
                hist.eval_blocked_s += time.perf_counter() - tb
                if target_return is not None and ret >= target_return:
                    solved_at = t
                    break
            round_i += window
        self._sync()     # end-of-run barrier closing the timed window
        wall = time.perf_counter() - t0

        hist.wall_s = wall
        hist.sampling_hz = (self.total_frames - frames0) / wall
        hist.update_hz = (self.total_updates - updates0) / wall
        hist.update_frame_hz = hist.update_hz * cfg.batch_size
        hist.transfer_stats = self.transfer.stats()
        hist.solved_time = solved_at
        return hist
