"""Runner of the cells whose timed path is the port's fused Spreeze
megastep, ``SpreezeTrainer.train``: the sampler chunk (env step, actor,
n-step), the ring write, and K updates a round (the uniform gather or
PER's draw, weights and re-prioritisation; the SAC update with Adam and
polyak averaging), R rounds a dispatch.

Set-up builds one trainer and hands it the benchmark's draws, its
weights and its env states, all made on the device from the seed; its
``train()`` then runs the warm-up and the first megastep, the checked
updates among them, and one more megastep, and the window is a further
``train(max_seconds=...)`` on that same trainer. The reference follows
the warm-up and the first ``check_updates`` updates from the same
inputs.
"""
from __future__ import annotations

import gc
import math
from typing import Dict, List

import numpy as np
import torch

from bench.lib import compare
from bench.reference import sac_pendulum as reference
from bench.work import kernel_work, model_flops

ADAM_B1 = 0.9      # the program's Adam's first-moment rate (train/optimizer)


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's ``--seed``."""
    return [int(s) & (2 ** 63 - 1) for s in
            np.random.SeedSequence(seed).generate_state(n, np.uint64)]


class PendulumDraws:
    """The trainer's draw source (the methods of ``core.pipeline.Draws``),
    made by the benchmark: a Philox generator on the device, Pendulum's
    resets (theta in [-pi, pi), theta-dot in [-1, 1)) drawn as uniforms.
    While ``log`` is a list, every draw handed out is appended to it, in
    the trainer's order, for the reference."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.log = None

    def _resets(self, n: int, gen):
        u = torch.rand((2, n), generator=gen, device=self.device)
        return (2 * u[0] - 1) * math.pi, 2 * u[1] - 1

    def sampler_step(self, num_envs: int, act_dim: int):
        eps = torch.randn((num_envs, act_dim), generator=self.gen,
                          device=self.device)
        th, thdot = self._resets(num_envs, self.gen)
        if self.log is not None:
            self.log.append(("sampler", eps, th, thdot))
        return eps, {"th": th, "thdot": thdot}

    def _noises(self, noises: int, batch_size: int, act_dim: int):
        return torch.randn((noises, batch_size, act_dim), generator=self.gen,
                           device=self.device).unbind(0)

    def update(self, replay, batch_size: int, act_dim: int, noises: int = 2):
        raw = torch.randint(0, 2 ** 31 - 1, (batch_size,), generator=self.gen,
                            device=self.device, dtype=torch.int32)
        eps = self._noises(noises, batch_size, act_dim)
        if self.log is not None:
            self.log.append(("update", raw) + tuple(eps))
        return (raw % torch.clamp(replay.size, min=1),) + tuple(eps)

    def per_update(self, capacity: int, batch_size: int, act_dim: int,
                   noises: int = 2):
        u = torch.rand((capacity,), generator=self.gen,
                       device=self.device).clamp_(min=1e-12)
        gumbel = -torch.log(-torch.log(u))
        eps = self._noises(noises, batch_size, act_dim)
        if self.log is not None:
            self.log.append(("per", gumbel) + tuple(eps))
        return (gumbel,) + tuple(eps)

    def _round_gen(self, stream: int, round_i: int):
        s = seeds(self.seed + stream, round_i + 1)[-1]
        return torch.Generator(device=self.device).manual_seed(s)

    def eval_reset(self, n: int, round_i: int):
        th, thdot = self._resets(n, self._round_gen(1, round_i))
        return {"th": th, "thdot": thdot}

    def viz_reset(self, round_i: int):
        th, thdot = self._resets(1, self._round_gen(2, round_i))
        return {"th": th, "thdot": thdot}

    def get_state(self):
        return self.gen.get_state()

    def set_state(self, state) -> None:
        self.gen.set_state(state)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """The actor and the stacked critics, N(0, 1/fan_in) weights and zero
    biases, in the program's layout, drawn on the device from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = cfg["env"]

    def tower(dims, lead=()):
        out = {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn(lead + (a, b), generator=gen, device=device)
            out[f"l{i}"] = {"w": w / math.sqrt(a),
                            "b": torch.zeros(lead + (b,), device=device)}
        return out
    hidden = tuple(cfg["hidden"])
    return {"actor": tower((spec["obs_dim"],) + hidden
                           + (2 * spec["act_dim"],)),
            "q": tower((spec["obs_dim"] + spec["act_dim"],) + hidden + (1,),
                       lead=(cfg["critics"],))}


def make_env_states(cfg: dict, traffic: dict, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = traffic["num_envs"]
    u = torch.rand((2, n), generator=gen, device=device)
    return {"th": (2 * u[0] - 1) * math.pi, "thdot": 2 * u[1] - 1,
            "t": torch.zeros((n,), dtype=torch.int32, device=device)}


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0):
    return {k: torch.linalg.vector_norm(v.detach()) * scale
            for k, v in tree.items()}


class Cell:
    """One run of a megastep cell: ``setup``, ``window``, ``traced``,
    ``release``, ``check`` (``bench/lib/harness.py`` calls them in that
    order)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.seeds = seeds(seed, 4)

    # ------------------------------------------------------------------ #
    def _trainer_config(self):
        from repro_torch.core import SpreezeConfig
        from repro_torch.rl import AlgoHP
        cfg, tr = self.cfg, self.traffic
        hp = AlgoHP(algo=cfg["algo"], gamma=cfg["gamma"], tau=cfg["tau"],
                    lr=cfg["lr"], hidden=tuple(cfg["hidden"]),
                    init_alpha=cfg["init_alpha"],
                    autotune_alpha=cfg["autotune_alpha"],
                    target_entropy_scale=cfg["target_entropy_scale"])
        return SpreezeConfig(
            env_name=cfg["env"]["name"], algo=cfg["algo"],
            num_envs=tr["num_envs"], batch_size=tr["batch_size"],
            replay_capacity=cfg["replay_capacity"],
            warmup_frames=tr["warmup_frames"], chunk_len=tr["chunk_len"],
            updates_per_round=tr["updates_per_round"],
            rounds_per_dispatch=tr["rounds_per_dispatch"],
            prioritized=tr["prioritized"], per_alpha=cfg["per_alpha"],
            per_beta=cfg["per_beta"], nstep=cfg["nstep"],
            eval_every_rounds=tr["eval_every_rounds"], viz_every_rounds=0,
            seed=self.seeds[0] & 0xFFFFFFFF, hp=hp, device=str(self.device))

    def _frames_per_megastep(self) -> int:
        t = self.traffic
        return t["num_envs"] * t["chunk_len"] * t["rounds_per_dispatch"]

    def _megasteps(self, n: int):
        """``n`` megasteps through ``train()`` (after the warm-up, which
        the first call runs)."""
        t = self.traffic
        chunk = t["num_envs"] * t["chunk_len"]
        warm = -(-t["warmup_frames"] // chunk) * chunk
        self.trainer.train(max_seconds=1e9, max_frames=max(
            self.trainer.total_frames, warm)
            + n * self._frames_per_megastep())

    def setup(self) -> None:
        from repro_torch.core import SpreezeTrainer
        self.draws = PendulumDraws(self.seeds[1], self.device)
        tr = self.trainer = SpreezeTrainer(self._trainer_config(),
                                           draws=self.draws)
        self.weights = make_weights(self.cfg, self.seeds[2], self.device)
        self.env0 = make_env_states(self.cfg, self.traffic, self.seeds[3],
                                    self.device)
        with torch.no_grad():
            for mine, theirs in ((self.weights["actor"], tr.state.actor),
                                 (self.weights["q"], tr.state.q),
                                 (self.weights["q"], tr.state.q_target)):
                for k, v in reference.flat("", mine).items():
                    reference.flat("", theirs)[k].copy_(v)
        tr.env_states = {k: v.clone() for k, v in self.env0.items()}
        self.start = {k: v.detach().clone() for k, v in self._params().items()}
        self.draws.log = []
        self.captured = {"losses": []}
        inner = tr._update
        n_check = self.traffic["check_updates"]

        def recorded(state, batch, *eps):
            state, metrics = inner(state, batch, *eps)
            cap = self.captured
            if len(cap["losses"]) < n_check:
                cap["losses"].append((metrics["critic_loss"].clone(),
                                      metrics["actor_loss"].clone()))
                if len(cap["losses"]) == 1:
                    cap["grad"] = _norms(self._moments(),
                                         1.0 / (1.0 - ADAM_B1))
                if len(cap["losses"]) == n_check:
                    now = self._params()
                    cap["change"] = {k: torch.linalg.vector_norm(
                        now[k].detach() - self.start[k]) for k in now}
                    self.log, self.draws.log = self.draws.log, None
            return state, metrics
        tr._update = recorded
        rounds = -(-n_check // self.traffic["updates_per_round"])
        self._megasteps(-(-rounds // self.traffic["rounds_per_dispatch"]))
        tr._update = inner
        self._megasteps(1)       # every shape of the window warmed

    def _params(self) -> Dict[str, torch.Tensor]:
        s = self.trainer.state
        return {**reference.flat("actor", s.actor), **reference.flat("q", s.q),
                **reference.flat("q_target", s.q_target),
                "log_alpha": s.log_alpha}

    def _moments(self) -> Dict[str, torch.Tensor]:
        s = self.trainer.state
        return {**reference.flat("actor", s.opt_actor.mu),
                **reference.flat("q", s.opt_q.mu),
                "log_alpha": s.opt_alpha.mu}

    # ------------------------------------------------------------------ #
    def window(self, seconds: float) -> dict:
        hist = self.trainer.train(max_seconds=seconds)
        updates = round(hist.update_hz * hist.wall_s)
        frames = round(hist.sampling_hz * hist.wall_s)
        cfg, t = self.cfg, self.traffic
        spec, hidden = cfg["env"], list(cfg["hidden"])
        actor = [spec["obs_dim"]] + hidden + [2 * spec["act_dim"]]
        critic = [spec["obs_dim"] + spec["act_dim"]] + hidden + [1]
        flops = (updates * t["batch_size"]
                 * model_flops.sac_update_flops_per_sample(actor, critic,
                                                           cfg["critics"])
                 + frames * model_flops.mlp_forward_flops(actor))
        return {"wall_s": hist.wall_s, "updates": updates, "frames": frames,
                "update_frame_hz": hist.update_frame_hz,
                "model_flops": flops, "attempted": updates, "failed": 0}

    def traced(self, tracer) -> dict:
        """Spans around the megastep, the sampler chunk, the ring write
        (the transfer's push) and the update round, and each replay
        kernel's calls logged, over ``trace_megasteps`` megasteps."""
        from repro_torch.kernels import ops as kops
        tr = self.trainer
        for attr in ("megastep", "sampler_chunk", "update_round"):
            tracer.span_around(tr, attr, attr)
        tracer.span_around(tr.transfer, "push", "transfer.push")
        tracer.kernel_calls(kops, "ring_write_fields", "ring_write",
                            _ring_write_work)
        tracer.kernel_calls(kops, "ring_gather_fields", "ring_gather",
                            _ring_gather_work)
        tracer.kernel_calls(kops, "per_topk", "per_topk", _per_topk_work)
        tracer.kernel_calls(kops, "priority_scatter", "priority_scatter",
                            _scatter_work)
        n = self.traffic["trace_megasteps"]
        return {"megasteps": n,
                "rounds": n * self.traffic["rounds_per_dispatch"],
                "updates": n * self.traffic["rounds_per_dispatch"]
                * self.traffic["updates_per_round"],
                "block": lambda: self._megasteps(n)}

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ #
    def program_numbers(self) -> dict:
        cap = self.captured
        return {"losses": [[float(c), float(a)] for c, a in cap["losses"]],
                "grad": {k: float(v) for k, v in cap["grad"].items()},
                "change": {k: float(v) for k, v in cap["change"].items()}}

    def reference_numbers(self, tf32: bool = False) -> dict:
        return reference.run(self.cfg, self.traffic, self.weights, self.env0,
                             iter(self.log), self.traffic["check_updates"],
                             self.device, tf32=tf32)

    def control_numbers(self) -> dict:
        """The reference in the program's place, its products in TF32: the
        step below the configuration's float32."""
        return self.reference_numbers(tf32=True)

    def check(self) -> Dict[str, float]:
        """The three gaps (``lib/compare``) of the program against the
        float32 reference; the q target's leaves move by polyak, not by
        a gradient, and are always compared."""
        ref = self.reference_numbers()
        return compare.numbers(self.program_numbers(), ref,
                               always=[k for k in ref["change"]
                                       if k.startswith("q_target.")])


def _row_bytes(fields) -> int:
    return sum(f[0].numel() * f.element_size() for f in fields)


def _ring_write_work(pools, rows, ptr, **kw):
    w = kernel_work.ring_write(rows[0].shape[0], _row_bytes(rows))
    return lambda: w


def _ring_gather_work(pools, idx, **kw):
    idx = idx.detach().clone()
    row = _row_bytes(pools)
    return lambda: kernel_work.ring_gather(
        idx.shape[0], row, distinct=int(torch.unique(idx).numel()))


def _per_topk_work(priorities, gumbel, alpha, k, **kw):
    w = kernel_work.per_topk(priorities.shape[0], k)
    return lambda: w


def _scatter_work(priorities, idx, values, **kw):
    idx = idx.detach().clone()
    return lambda: kernel_work.priority_scatter(
        idx.shape[0], distinct=int(torch.unique(idx).numel()))
