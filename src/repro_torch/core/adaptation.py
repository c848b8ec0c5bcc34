"""Hyperparameter adaptation (paper §3.4). Counterpart of
``repro/core/adaptation.py``.

The paper tunes two parallelization hyperparameters, using that both
throughput curves are convex and (nearly) independent:

* **batch size** (device-bound): grow geometrically while the *update
  frame rate* (updates/s x batch) keeps improving, and stop when the
  gain falls under a threshold (the device is saturated), so the update
  *frequency* is not given up (Table 3: the BS32768 row).
* **number of sampling processes** (host-bound): grow the vectorized env
  count while the sampling frame rate keeps improving.

A third knob, **rounds per dispatch**, grows the megastep's round count
while rounds/s keeps improving (the per-megastep host work amortizes,
then the device's share dominates and the curve flattens).

The utilization the paper reads from nvidia-smi / psutil is replaced by
the measured rate of the probed calls, each timed to its completion
(``torch.cuda.synchronize`` after every call on the card): the quantity
the utilization stood for.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch._tree import tree_map


@dataclass
class AdaptLog:
    candidates: List[Dict] = field(default_factory=list)
    chosen: int = 0


def _block(device) -> None:
    """Wait for the device's work, as the reference's
    ``block_until_ready``; nothing to wait for on the CPU."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn: Callable[[], None], iters: int, warmup: int = 1,
             device=None) -> float:
    """Wall seconds a call of ``fn``, the device waited for after each."""
    for _ in range(warmup):
        fn()
        _block(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _block(device)
    return (time.perf_counter() - t0) / iters


def tune_geometric(measure: Callable[[int], float], grid: Sequence[int], *,
                   min_gain: float = 0.10) -> Tuple[int, AdaptLog]:
    """Walk a geometric grid while throughput improves by >= min_gain.

    ``measure(candidate) -> throughput``. Convexity (paper §3.4.2) lets
    the walk stop at the first step under the threshold."""
    log = AdaptLog()
    best_v, best_thru = grid[0], measure(grid[0])
    log.candidates.append({"value": grid[0], "throughput": best_thru})
    for v in grid[1:]:
        thru = measure(v)
        log.candidates.append({"value": v, "throughput": thru})
        if thru < best_thru * (1.0 + min_gain):
            break                      # the convex curve has flattened
        best_v, best_thru = v, thru
    log.chosen = best_v
    return best_v, log


def tune_batch_size(make_update_call: Callable[[int], Callable[[], None]], *,
                    grid: Sequence[int] = (128, 256, 512, 1024, 2048, 4096,
                                           8192, 16384, 32768),
                    iters: int = 5, min_gain: float = 0.10, device=None
                    ) -> Tuple[int, AdaptLog]:
    """Pick the batch size maximizing the update *frame* rate (Hz x
    batch)."""

    def measure(bs: int) -> float:
        return bs / _time_fn(make_update_call(bs), iters, device=device)

    return tune_geometric(measure, grid, min_gain=min_gain)


def tune_num_envs(make_sample_call: Callable[[int], Callable[[], None]], *,
                  grid: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
                  chunk_len: int = 32, iters: int = 5,
                  min_gain: float = 0.10, device=None
                  ) -> Tuple[int, AdaptLog]:
    """Pick the env count maximizing the sampling frame rate."""

    def measure(n: int) -> float:
        return n * chunk_len / _time_fn(make_sample_call(n), iters,
                                        device=device)

    return tune_geometric(measure, grid, min_gain=min_gain)


def tune_rounds_per_dispatch(make_megastep_call: Callable[[int],
                                                          Callable[[], None]],
                             *, grid: Sequence[int] = (1, 2, 4, 8, 16),
                             iters: int = 5, min_gain: float = 0.10,
                             device=None) -> Tuple[int, AdaptLog]:
    """Pick the megastep round count maximizing rounds/s."""

    def measure(r: int) -> float:
        return r / _time_fn(make_megastep_call(r), iters, device=device)

    return tune_geometric(measure, grid, min_gain=min_gain)


def probe_replay(obs_dim: int, act_dim: int, cap: int, gamma: float,
                 generator: torch.Generator, device="cuda"):
    """A filled synthetic ring for the update-rate probe, with the field
    set and value domains the trainer feeds the update: the ``"disc"``
    row the trainer always writes, and ``done`` a {0, 1} indicator."""
    from repro_torch.replay import buffer as rb

    dev = resolve_device(device)
    fill = {k: torch.randn((cap,) + tuple(s), generator=generator,
                           device=dev).to(d)
            for k, (s, d) in rb.trainer_specs(obs_dim, act_dim).items()}
    fill["done"] = (fill["done"] > 0).to(torch.float32)
    fill["disc"] = gamma * (1.0 - fill["done"])
    return rb.ReplayState(
        data=fill, ptr=torch.zeros((), dtype=torch.int32, device=dev),
        size=torch.full((), cap, dtype=torch.int32, device=dev))


def auto_tune(env_name: str = "pendulum", algo: str = "sac", *,
              bs_grid: Sequence[int] = (128, 512, 2048, 8192, 32768),
              env_grid: Sequence[int] = (1, 2, 4, 8, 16, 32),
              rpd_grid: Sequence[int] = (1, 2, 4, 8),
              iters: int = 3, device="cuda") -> Dict:
    """End-to-end adaptation for a ``SpreezeConfig`` (the paper's auto
    mode). Returns {"batch_size", "num_envs", "rounds_per_dispatch",
    "bs_log", "env_log", "rpd_log"}. The searches are independent
    (paper §3.4.2) and run one after the other: the update probe runs
    the port's update on ``rb.sample`` batches of a synthetic ring (the
    ``ring_gather`` kernel on the card), the sampling probe a chunk of
    the env under the actor, and the last search a ``SpreezeTrainer``
    megastep at the two tuned values."""
    from repro_torch.core.pipeline import Draws, SpreezeConfig, SpreezeTrainer
    from repro_torch.envs import base as env_base
    from repro_torch.replay import buffer as rb
    from repro_torch.rl.base import AlgoHP, get_algo

    dev = resolve_device(device)
    env = env_base.make(env_name)
    spec = env.spec
    mod = get_algo(algo)
    hp = AlgoHP(algo=algo)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = mod.init_state(gen, spec.obs_dim, spec.act_dim, hp, dev)
    update = mod.make_update_step(hp, spec.obs_dim, spec.act_dim)
    act = mod.make_act(hp)
    replay = probe_replay(spec.obs_dim, spec.act_dim, max(bs_grid) * 2,
                          hp.gamma, gen, dev)

    def make_update_call(bs: int):
        draws = Draws(env, 1, 2, dev)
        holder = {"s": tree_map(torch.clone, state)}

        def call():
            idx, *eps = draws.update(replay, bs, spec.act_dim,
                                     mod.UPDATE_NOISES)
            holder["s"], _ = update(holder["s"], rb.sample(replay, idx),
                                    *eps)
        return call

    chunk_len = 32

    def make_sample_call(n: int):
        draws = Draws(env, 3, 4, dev)
        holder = {"st": env.reset_batch(n, draws.gen)}

        @torch.no_grad()
        def call():
            st = holder["st"]
            for _ in range(chunk_len):
                eps, reset = draws.sampler_step(n, spec.act_dim)
                a = act(state.actor, env.observe(st), eps)
                st, _, _, _ = env.autoreset_step(st, a, reset)
            holder["st"] = st
        return call

    bs, bs_log = tune_batch_size(make_update_call, grid=bs_grid, iters=iters,
                                 device=dev)
    ne, env_log = tune_num_envs(make_sample_call, grid=env_grid,
                                chunk_len=chunk_len, iters=iters, device=dev)

    def make_megastep_call(r: int):
        cfg = SpreezeConfig(env_name=env_name, algo=algo, num_envs=ne,
                            batch_size=bs, chunk_len=chunk_len,
                            replay_capacity=max(2 * bs, 4096),
                            warmup_frames=0, eval_every_rounds=10**9,
                            rounds_per_dispatch=r, device=str(dev))
        return SpreezeTrainer(cfg).megastep

    rpd, rpd_log = tune_rounds_per_dispatch(make_megastep_call,
                                            grid=rpd_grid, iters=iters,
                                            device=dev)
    return {"batch_size": bs, "num_envs": ne, "rounds_per_dispatch": rpd,
            "bs_log": bs_log, "env_log": env_log, "rpd_log": rpd_log}
