"""Builders: each contract's entry point made at a probe size. Counterpart
of ``repro/analysis/hlolint/entrypoints.py``, at the reference's sizes.

Contracts are *declared* next to their entry points (``HLOLINT_CONTRACTS``
in the modules of ``CONTRACT_MODULES``); this module knows how to *make*
each one: ``BUILDERS[name](device, census)`` builds it on ``device`` and
returns ``{"dispatch", "state", "params"}`` (``checks.run_contract``).
Parameters come from the port's own ``init_params`` / ``init_state``.

- The trainer's entry points (``megastep*``, ``sampler_chunk``,
  ``update_round``): a pendulum SAC trainer, capacity 2048 and batch 32,
  R = 2 rounds of K = 2 updates, warmed up; the sharded arms at capacity
  4096 and batch 64 on ``make_ac_mesh(2, 4, devices=[dev] * 8)`` (the
  stand-in grid that repeats one device, so nothing is skipped).
- ``replay_add_batch``: 8 rows into a 256-row ring.
- ``ring_gather_sharded`` / ``per_topk_sharded``: capacity 1024, batch /
  k 64, on the same 2 x 4 grid.
- ``rope``: a layer's q (2, 32, 4, 64) and k (2, 32, 2, 64), bf16, at
  positions ``arange(32)``.
- ``finite_guard``: ``faults.tree_finite`` over a probe trainer's bundle.
- ``lm_train_step`` / ``serve_decode_step``: the first dense architecture
  in sorted order (h2o-danube-1.8b), reduced, at seq 32 and batch 2.

**The meta device.** A trainer cannot be built on ``meta`` (a generator
has no meta form), so the megastep does not run there as it is. Its
meta build is a *twin*: the trainer is built on the CPU at the probe
size, and a shallow copy of it gets the state, the ring and the env
states moved to ``meta`` (on a grid of meta devices for the sharded
arms, placed again), a ring write bound to that ring, and a draw source
that hands out empty meta tensors of the draws' shapes. The twin then
runs the trainer's own ``megastep`` / ``sampler_chunk`` /
``update_round`` code on ``meta``, where each kernel route reports its
calls to the census: that is where the ``launches`` family reads the
megastep contracts' kernel calls, also in the CPU tests.
"""
from __future__ import annotations

import copy
import functools
import importlib
from typing import Callable, Dict, List

import torch

from repro_torch._tree import tree_map

META = torch.device("meta")

#: modules that may declare module-level HLOLINT_CONTRACTS tuples
CONTRACT_MODULES = (
    "repro_torch.core.pipeline",
    "repro_torch.core.faults",
    "repro_torch.kernels.ops",
    "repro_torch.train.trainer",
    "repro_torch.serve.engine",
    "repro_torch.replay.buffer",
)

#: the sharded probes' grid: 2 ac rows x 4 batch columns
AC, BATCH = 2, 4


def collect_contracts() -> List:
    out = []
    for name in CONTRACT_MODULES:
        mod = importlib.import_module(name)
        out.extend(getattr(mod, "HLOLINT_CONTRACTS", ()))
    return out


def _meta(tree):
    return tree_map(lambda t: t.to(META) if torch.is_tensor(t) else t, tree)


def _grid(device: torch.device):
    from repro_torch.launch.mesh import make_ac_mesh
    return make_ac_mesh(AC, BATCH, devices=[device] * (AC * BATCH))


# --------------------------------------------------------------------------- #
# the Spreeze trainer
# --------------------------------------------------------------------------- #

class _MetaDraws:
    """A draw source of empty meta tensors with the trainer's draws'
    shapes (``core.pipeline.Draws``' methods): the twin's draws."""

    def __init__(self, env):
        self.env = env
        self._gen = torch.Generator().manual_seed(0)

    def sampler_step(self, num_envs: int, act_dim: int):
        return (torch.empty((num_envs, act_dim), device=META),
                _meta(self.env.reset_draws(num_envs, self._gen)))

    def _noises(self, noises: int, batch_size: int, act_dim: int):
        return tuple(torch.empty((batch_size, act_dim), device=META)
                     for _ in range(noises))

    def update(self, replay, batch_size: int, act_dim: int,
               noises: int = 2):
        idx = torch.empty((batch_size,), dtype=torch.int32, device=META)
        return (idx,) + self._noises(noises, batch_size, act_dim)

    def per_update(self, capacity: int, batch_size: int, act_dim: int,
                   noises: int = 2):
        return ((torch.empty((capacity,), device=META),)
                + self._noises(noises, batch_size, act_dim))


def _spreeze_trainer(device, census, *, sharded=False, prioritized=False):
    """A warmed-up probe trainer on ``device`` (its grid named to the
    census and placed under it), or, on ``meta``, the twin of one built on
    the CPU."""
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    capacity, batch = (4096, 64) if sharded else (2048, 32)
    home = torch.device("cpu") if device.type == "meta" else device
    mesh = _grid(home) if sharded else None
    if mesh is not None and device.type != "meta":
        census.watch(mesh)
    cfg = SpreezeConfig(
        env_name="pendulum", algo="sac", num_envs=2, batch_size=batch,
        chunk_len=4, updates_per_round=2, rounds_per_dispatch=2,
        warmup_frames=64, replay_capacity=capacity,
        eval_every_rounds=10**9, mesh=mesh, prioritized=prioritized,
        seed=3, device=str(home))
    with census.placing():
        tr = SpreezeTrainer(cfg)
        tr._warmup()
    if device.type == "meta":
        tr = _meta_twin(tr, census)
    params = {"capacity": capacity, "batch": batch, "k": batch,
              "rounds": cfg.rounds_per_dispatch,
              "updates": cfg.updates_per_round,
              "rows": cfg.num_envs * cfg.chunk_len, "hidden": cfg.hp.hidden[0],
              "groups": tr.layout.groups if tr.layout else 1}
    return tr, params


def _meta_twin(tr, census):
    """A shallow copy of ``tr`` whose state, ring and env states live on
    ``meta`` (on a grid of meta devices when ``tr`` runs on a mesh), with
    a ring write bound to that ring and ``_MetaDraws``."""
    from repro_torch.core import model_parallel as mp
    from repro_torch.core.transfer import make_transfer
    from repro_torch.replay import buffer as rb
    from repro_torch.replay import prioritized as per
    twin = copy.copy(tr)
    twin.device = META
    twin.draws = _MetaDraws(tr.env)
    state, replay = _meta(mp.whole_state(tr)), _meta(mp.whole_replay(tr))
    add = per.add_batch if tr.cfg.prioritized else rb.add_batch
    if tr.layout is None:
        twin.state, twin.replay = state, replay
    else:
        mesh = _grid(META)
        census.watch(mesh)
        twin.layout = mp.MeshLayout(mesh, tr.cfg.placement)
        twin.rules = twin.layout.rules
        with census.placing():
            twin.state = mp.place_state(state, twin.layout)
            twin.replay = mp.place_replay(replay, twin.layout)
        twin._update = twin._make_update()
        add = functools.partial(add, rules=twin.rules)
    twin.transfer = make_transfer("shared", add_fn=add, device=META)
    twin.env_states = _meta(tr.env_states)
    return twin


def _megastep(*, sharded: bool = False, prioritized: bool = False):
    def build(device, census) -> Dict:
        tr, params = _spreeze_trainer(device, census, sharded=sharded,
                                      prioritized=prioritized)
        return {"dispatch": tr.megastep,
                "state": lambda: {"state": tr.state, "replay": tr.replay},
                "params": params}
    return build


def _sampler_chunk(device, census) -> Dict:
    tr, params = _spreeze_trainer(device, census)

    def dispatch() -> None:
        tr.env_states, _flat, _rew = tr.sampler_chunk(tr.state.actor,
                                                      tr.env_states)

    return {"dispatch": dispatch,
            "state": lambda: {"env_states": tr.env_states},
            "params": params}


def _update_round(device, census) -> Dict:
    tr, params = _spreeze_trainer(device, census)

    def dispatch() -> None:
        tr.state, _loss = tr.update_round(tr.state, tr.replay)

    return {"dispatch": dispatch,
            "state": lambda: {"state": tr.state, "replay": tr.replay},
            "params": params}


# --------------------------------------------------------------------------- #
# the replay ring
# --------------------------------------------------------------------------- #

def _replay_add_batch(device, census) -> Dict:
    from repro_torch.replay import buffer
    state = buffer.init_replay(256, buffer.specs_for_env(3, 1), device)
    batch = {k: torch.ones((8,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=device)
             for k, v in state.data.items()}
    live = {"state": state}

    def dispatch() -> None:
        live["state"] = buffer.add_batch(live["state"], batch)

    return {"dispatch": dispatch,
            "state": lambda: {"state": live["state"]},
            "params": {"capacity": 256, "rows": 8}}


# --------------------------------------------------------------------------- #
# the sharded replay ops, standalone on the trainer's grid
# --------------------------------------------------------------------------- #

def _ops_rules(device, census):
    from repro_torch.distributed.sharding import trainer_rules
    mesh = _grid(device)
    census.watch(mesh)
    return mesh, trainer_rules(mesh, "ac")


def _shards(rules, whole: torch.Tensor, census) -> List[torch.Tensor]:
    """``whole`` split into the batch groups' shards, each placed on its
    group."""
    from repro_torch.distributed.sharding import (group_devices,
                                                  group_windows, to_group)
    devs = group_devices(rules)
    rows = whole.shape[0] // len(devs)
    group_windows(rules, rows)    # made once, as a trainer's warmup does
    with census.placing():
        return [to_group(whole.narrow(0, g * rows, rows), dev, copy=True)
                for g, dev in enumerate(devs)]


def _per_topk_sharded(device, census) -> Dict:
    from repro_torch.kernels import ops as kops
    _, rules = _ops_rules(device, census)
    cap, k = 1024, 64
    groups = rules.axis_size(rules.batch)
    gen = torch.Generator().manual_seed(0)
    pri = (torch.rand((cap,), generator=gen) + 0.1).to(device)
    u = torch.rand((cap,), generator=gen).clamp_(min=1e-12)
    gum = (-torch.log(-torch.log(u))).to(device)
    shards = _shards(rules, pri, census)

    def dispatch() -> None:
        kops.per_topk_sharded(shards, gum, 0.6, k, rules)

    return {"dispatch": dispatch, "state": lambda: {},
            "params": {"capacity": cap, "k": k, "groups": groups,
                       "batch": k}}


def _ring_gather_sharded(device, census) -> Dict:
    from repro_torch.kernels import ops as kops
    _, rules = _ops_rules(device, census)
    cap, batch = 1024, 64
    groups = rules.axis_size(rules.batch)
    gen = torch.Generator().manual_seed(2)
    data = torch.arange(cap * 3, dtype=torch.float32).reshape(cap, 3)
    shards = _shards(rules, data.to(device), census)
    idx = torch.randint(0, cap, (batch,), generator=gen,
                        dtype=torch.int32).to(device)

    def dispatch() -> None:
        kops.ring_gather_sharded(shards, idx, rules)

    return {"dispatch": dispatch, "state": lambda: {},
            "params": {"capacity": cap, "batch": batch, "groups": groups}}


def _rope(device, census) -> Dict:
    from repro_torch.kernels import ops as kops
    B, S, H, KV, d = 2, 32, 4, 2, 64
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((B, S, H, d), generator=gen).to(torch.bfloat16)
    k = torch.randn((B, S, KV, d), generator=gen).to(torch.bfloat16)
    q, k, pos = q.to(device), k.to(device), torch.arange(S).to(device)

    def dispatch() -> None:
        kops.rope(q, k, pos, pos, 1e4)

    return {"dispatch": dispatch, "state": lambda: {},
            "params": {"batch": B, "seq": S}}


# --------------------------------------------------------------------------- #
# the resilience layer
# --------------------------------------------------------------------------- #

def _finite_guard(device, census) -> Dict:
    from repro_torch.core import faults
    from repro_torch.core import model_parallel as mp
    tr, _ = _spreeze_trainer(device, census)
    # resume_lib.bundle_from's tensors; its draws' state is the host's
    bundle = {"state": mp.whole_state(tr), "replay": mp.whole_replay(tr),
              "env_states": tr.env_states}

    def dispatch() -> None:
        faults.tree_finite(bundle)

    return {"dispatch": dispatch, "state": lambda: {}, "params": {}}


# --------------------------------------------------------------------------- #
# LM train / serve
# --------------------------------------------------------------------------- #

def _smoke_run_config():
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.base import InputShape, RunConfig
    name = next(a for a in sorted(ARCHS)
                if get_config(a).family == "dense")
    shape = InputShape("hlolint-smoke", seq_len=32, global_batch=2,
                       kind="train")
    return RunConfig(model=get_config(name).reduced(), shape=shape)


def _generator(device: torch.device) -> torch.Generator:
    """Seed 0 on ``device`` (on the CPU for ``meta``, whose draws are
    moved there)."""
    return torch.Generator(
        device="cpu" if device.type == "meta" else device).manual_seed(0)


def _lm_params(rc):
    return {"layers": rc.model.num_layers, "batch": rc.shape.global_batch,
            "seq": rc.shape.seq_len}


def _lm_train_step(device, census) -> Dict:
    from repro_torch.data.tokens import make_batch
    from repro_torch.train.trainer import init_train_state, make_train_step
    rc = _smoke_run_config()
    gen = _generator(device)
    params, opt_state, opt = init_train_state(rc, gen, device=device)
    batch = tree_map(lambda t: t.to(device),
                     make_batch(rc.model, rc.shape, gen))
    step_fn = make_train_step(rc, opt)
    live = {"params": params, "opt_state": opt_state}

    def dispatch() -> None:
        live["params"], live["opt_state"], _m = step_fn(
            live["params"], live["opt_state"], batch)

    return {"dispatch": dispatch, "state": lambda: dict(live),
            "params": _lm_params(rc)}


def _serve_decode_step(device, census) -> Dict:
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve.engine import _grow_cache, make_decode_step
    from repro_torch.train.trainer import dtype_of
    rc = _smoke_run_config()
    cfg = rc.model
    gen = _generator(device)
    params = factory.init_params(cfg, gen, device=device)
    batch = tree_map(lambda t: t.to(device), make_batch(cfg, rc.shape, gen))
    seq = batch["tokens"].shape[1]
    with torch.no_grad():
        cache, logits = factory.prefill(params, batch, cfg, seq + 8,
                                        dtype=dtype_of(rc.compute_dtype))
    cache = _grow_cache(cfg, cache, seq + 8)
    tok = torch.zeros((batch["tokens"].shape[0], 1), dtype=torch.int32,
                      device=device)
    decode_fn = make_decode_step(rc)
    live = {"cache": cache,
            "pos": torch.full((), seq, dtype=torch.int32, device=device)}

    def dispatch() -> None:
        with torch.no_grad():
            _lg, live["cache"] = decode_fn(params, tok, live["cache"],
                                           live["pos"])
        live["pos"] = live["pos"] + 1

    return {"dispatch": dispatch, "state": lambda: {"cache": live["cache"]},
            "params": _lm_params(rc)}


BUILDERS: Dict[str, Callable[..., Dict]] = {
    "megastep": _megastep(),
    "megastep_per": _megastep(prioritized=True),
    "megastep_sharded": _megastep(sharded=True),
    "megastep_sharded_per": _megastep(sharded=True, prioritized=True),
    "sampler_chunk": _sampler_chunk,
    "update_round": _update_round,
    "replay_add_batch": _replay_add_batch,
    "per_topk_sharded": _per_topk_sharded,
    "ring_gather_sharded": _ring_gather_sharded,
    "rope": _rope,
    "finite_guard": _finite_guard,
    "lm_train_step": _lm_train_step,
    "serve_decode_step": _serve_decode_step,
}
