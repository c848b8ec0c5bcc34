"""The dry run: every (arch x shape) pair's step on the meta device, and its
roofline on one H100.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each pair for its production mesh from ``ShapeDtypeStruct``s
and reads the compiled artifact. The port has no compiled artifact: it
runs the pair's own step on the meta device, at full width and full
depth, in bf16 parameters with float32 Adam moments (the reference's
``_run_config``), and counts what the step does with the census of
``launch.analysis`` (``OpCensus``): every aten op's FLOPs and bytes, each
kernel's calls and work from its meta route, the peak of live bytes.
Nothing is allocated and nothing computes, so a 1T-parameter MoE runs on
a laptop's CPU. A pair runs:

- train: ``train.trainer.make_train_step`` (``factory.loss_fn``, its
  gradients, the optimizer's in-place update);
- prefill: ``serve.engine.make_prefill_step``;
- decode: one ``serve.engine.make_decode_step`` step over a full cache.

The meta run counts every layer, so there are no shallow probes: the
reference's ``_probe_costs`` extrapolated costs from 1- and 2-period
unrolled variants because XLA counts a loop body once; ``_extrapolate``
stays, and the tests hold it against the full-depth census.

The record keeps the reference's keys. ``peak_memory_per_device`` is the
census's peak for one H100 running the whole step (arguments and the
peak of the temporaries); beside it, ``state_bytes_per_device``: what a
device would hold of the parameters, the optimizer state and the inputs
under the reference's rules for ``--data`` x ``--model`` (x 2 pods). The
port runs an LM pair on one card, so its ``collective_bytes_per_device``
is null (not 0) and ``notes`` says so. ``--spreeze`` runs the RL update
on the port's single-controller grid (``core.model_parallel.
make_spreeze_update``) and reports what ``to_group`` moves between
groups, under the ac and the dp placements.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all            # 40 pairs
  python -m repro_torch.launch.dryrun --all --multipod
  python -m repro_torch.launch.dryrun --spreeze        # RL update, ac + dp
  python -m repro_torch.launch.dryrun --spreeze-arch smollm-360m
  python -m repro_torch.launch.dryrun --spreeze-sampler
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import sharding
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (batch_shardings, cache_shardings,
                                      decode_input_specs, input_specs,
                                      shape_supported)

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")
META = torch.device("meta")
ONE_CARD = ("the port runs an LM pair on one card: the census is of one "
            "H100 running the whole step, no collective measured; "
            "state_bytes_per_device is a device's share under the "
            "reference's rules")


def _run_config(cfg, shape) -> RunConfig:
    """The production precision policy: bf16 parameters and compute, f32
    Adam moments (the reference's ``fsdp`` chooses the rules here, not
    the run)."""
    return RunConfig(model=cfg, shape=shape, param_dtype="bfloat16",
                     compute_dtype="bfloat16")


def _scale_depth(cfg, periods: int):
    """A same-family variant that is ``periods`` scan periods deep."""
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=periods * cfg.hybrid_attn_every)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=periods,
                                   encoder_layers=periods)
    return dataclasses.replace(cfg, num_layers=periods)


def _n_periods(cfg) -> float:
    if cfg.family == "hybrid":
        return cfg.num_layers / cfg.hybrid_attn_every
    return float(cfg.num_layers)


def _extrapolate(c1: Dict, c2: Dict, n: float) -> Dict:
    """outside + n x per-period, from the costs of 1- and 2-period runs:
    every number of ``c1`` (nested dicts key by key, a key missing on one
    side read as 0)."""
    out = {}
    for k in set(c1) | set(c2):
        a, b = c1.get(k, 0), c2.get(k, 0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = _extrapolate(a or {}, b or {}, n)
        else:
            out[k] = max(a + (n - 1) * (b - a), 0)
    return out


def census_costs(census: analysis.OpCensus) -> Dict[str, Any]:
    """The numbers of a census that grow with depth (``_extrapolate``'s
    input): FLOPs, bytes and each kernel's calls."""
    return {"flops": census.flops, "flops_f32": census.flops_f32,
            "bytes": census.bytes, "aten_flops": census.aten_flops,
            "kernels": census.kernel_calls}


# --------------------------------------------------------------------------- #
# the pairs
# --------------------------------------------------------------------------- #

def _params(cfg):
    from repro_torch.models import factory
    return factory.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16, device=META)


def _lower_train(rc: RunConfig):
    """One train step -> (census, the state trees, the inputs)."""
    from repro_torch.train.trainer import init_train_state, make_train_step
    params, opt_state, opt = init_train_state(
        rc, torch.Generator().manual_seed(0), device=META)
    batch = input_specs(rc.model, rc.shape)
    step = make_train_step(rc, opt)
    with analysis.OpCensus((params, opt_state, batch)) as census:
        step(params, opt_state, batch)
    return census, (params, opt_state), batch


def _lower_prefill(rc: RunConfig):
    from repro_torch.serve.engine import make_prefill_step
    params = _params(rc.model)
    batch = input_specs(rc.model, rc.shape)
    step = make_prefill_step(rc, rc.shape.seq_len)
    with torch.no_grad(), analysis.OpCensus((params, batch)) as census:
        step(params, batch)
    return census, (params,), batch


def _lower_decode(rc: RunConfig):
    from repro_torch.serve.engine import make_decode_step
    params = _params(rc.model)
    token, cache, pos = decode_input_specs(rc.model, rc.shape)
    step = make_decode_step(rc)
    with torch.no_grad(), \
            analysis.OpCensus((params, token, cache, pos)) as census:
        step(params, token, cache, pos)
    return census, (params,), {"tokens": token, "cache": cache}


def _lower_for(rc: RunConfig):
    if rc.shape.kind == "train":
        return _lower_train(rc)
    if rc.shape.kind == "prefill":
        return _lower_prefill(rc)
    return _lower_decode(rc)


def _leaf_bytes(leaf, spec, rules) -> float:
    return (leaf.numel() * leaf.element_size()
            / sharding.shard_counts(spec, rules))


def state_bytes_per_device(state, inputs, rules) -> float:
    """What one device holds under ``rules``: each parameter and optimizer
    leaf split by ``params_sharding_tree``, the inputs by
    ``batch_shardings`` (the cache by ``cache_shardings``)."""
    total = 0.0
    for tree in state:
        specs = sharding.params_sharding_tree(tree, rules)
        total += sum(_leaf_bytes(l, s, rules) for l, s in
                     zip(tree_leaves(tree), _spec_leaves(specs)))
    cache = inputs.get("cache")
    batch = {k: v for k, v in inputs.items() if k != "cache"}
    for k, spec in batch_shardings(batch, rules).items():
        total += _leaf_bytes(batch[k], spec, rules)
    if cache is not None:
        total += sum(_leaf_bytes(l, s, rules) for l, s in zip(
            tree_leaves(cache), _spec_leaves(cache_shardings(cache, rules))))
    return total


def _spec_leaves(specs):
    """The per-leaf tuples of a tree of splits (a split is a tuple, so
    it is not walked into)."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and hasattr(specs, "_fields")):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               seq_shard_attn: bool = True, remat: bool = True,
               data: int = 16, model: int = 16,
               fsdp: Optional[bool] = None, tag: str = "") -> Dict[str, Any]:
    """One (arch, shape)'s step on the meta device -> its record (or a
    skip record). ``data`` and ``model`` reshape the reference's pod and
    ``fsdp`` drops the data-axis weight split, for the per-device state
    bytes; by default TP-resident weights for B=1 long-context decode,
    FSDP everywhere else (the reference's policy)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if fsdp is None:
        fsdp = shape_name != "long_500k"
    ok, why = shape_supported(cfg, shape)
    mesh_name = f"2x{data}x{model}" if multi_pod else f"{data}x{model}"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    if tag:
        rec["variant"] = tag
    if not ok:
        rec["skipped"] = why
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, data=data, model=model)
    rules = sharding.standard_rules(mesh, sequence_parallel=seq_shard_attn,
                                    fsdp=fsdp)
    rc = dataclasses.replace(_run_config(cfg, shape), remat=remat)
    t0 = time.perf_counter()
    census, state, inputs = _lower_for(rc)
    t_run = time.perf_counter() - t0

    roof = analysis.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=1,
        flops_per_device=census.flops,
        flops_f32_per_device=census.flops_f32,
        bytes_per_device=census.bytes,
        collective_bytes_per_device=None,
        model_flops=analysis.model_flops_estimate(cfg, shape),
        peak_memory_per_device=float(census.peak_bytes),
        notes=ONE_CARD).finalize()
    rec.update(roof.to_dict())
    rec["lower_s"] = round(t_run, 1)
    rec["compile_s"] = None
    rec["collective_breakdown"] = None
    rec["fits_one_card"] = census.peak_bytes <= analysis.HBM_BYTES
    rec["state_bytes_per_device"] = state_bytes_per_device(state, inputs,
                                                           rules)
    rec["mesh_chips"] = mesh.size
    rec["census"] = census.summary()
    rec["card"] = analysis.CARD
    return rec


# --------------------------------------------------------------------------- #
# Spreeze: the RL update and the sampler at pod scale
# --------------------------------------------------------------------------- #

def lower_spreeze(*, multi_pod: bool = True, algo: str = "sac",
                  batch_size: int = 8192,
                  placement: str = "ac") -> Dict[str, Any]:
    """The RL update of the production mesh on the port's grid (ac = pod,
    batch = data, every position a meta device): placement ``ac`` is the
    paper's Fig. 2b (each pod one critic), ``dp`` the Fig. 2a baseline
    (the gradients summed over every group). Counts what ``to_group``
    moves between groups in one update, the placing not counted."""
    from repro_torch.core import model_parallel as mp
    mesh = make_production_mesh(multi_pod=multi_pod)
    grid = mp.spreeze_grid(mesh)
    census = analysis.OpCensus()
    census.watch(grid)
    with census.placing():
        update, state, batch, noises, _ = mp.make_spreeze_update(
            mesh, algo=algo, batch_size=batch_size, placement=placement,
            grid=grid)
    census.place(noises, (0, 0))
    with census:
        update(state, batch, *noises)
    received = census.moved_bytes_per_device()
    return {"mode": "spreeze_rl_update", "algo": algo,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "grid": dict(grid.shape), "groups": update.layout.groups,
            "batch_size": batch_size, "placement": placement,
            "flops_per_device": max(census.flops_by_group.values(),
                                    default=0),
            "bytes_per_device": max(census.bytes_by_group.values(),
                                    default=0),
            "collective_bytes_per_device": max(received.values(), default=0),
            "collective_count": census.move_count,
            "collective_breakdown": {"to_group": sum(census.moves.values())},
            "received_bytes_by_group": received,
            "unresolved_move_bytes": census.unresolved_move_bytes,
            "card": analysis.CARD}


def lower_spreeze_arch(arch: str, *, batch: int = 32, seq: int = 1024,
                       act_dim: int = 16) -> Dict[str, Any]:
    """RLHF-scale Spreeze: ``arch`` as the actor and critic backbone; one
    ``make_arch_spreeze_update`` (the critic loss's gradient over the two
    critics, the actor loss's over the actor, Adam on each; 5 backbone
    forwards, as the actor loss takes the critic loss's) on the meta
    device, bf16 towers as the reference's. The port runs the five towers
    on one card; ``state_bytes_per_device`` is a device's share under the
    reference's 2x16x16 ``spreeze_rules`` (the actor split over (data,
    model), the critics' ensemble dim over the pod)."""
    from repro_torch.core.model_parallel import make_arch_spreeze_update
    from repro_torch.rl import networks as nets
    from repro_torch.train.optimizer import make_optimizer
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=True)
    rules = sharding.spreeze_rules(mesh)
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    actor = nets.init_arch_policy(gen, cfg, act_dim, dtype=bf16, device=META)
    q = nets.init_arch_ensemble_q(gen, cfg, act_dim, dtype=bf16,
                                  device=META)
    q_target = tree_map(torch.empty_like, q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    opt = make_optimizer("adam", 3e-4)
    oa, oq = opt.init(actor), opt.init(q)
    data = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                  device=META),
            "act": torch.empty((batch, act_dim), device=META),
            "rew": torch.empty((batch,), device=META),
            "done": torch.empty((batch,), device=META),
            "eps": torch.empty((batch, act_dim), device=META)}
    update = make_arch_spreeze_update(cfg, opt, act_dim)
    t0 = time.perf_counter()
    with analysis.OpCensus((actor, q, q_target, oa, oq, data)) as census:
        update(actor, q, q_target, oa, oq, **data)
    t_run = time.perf_counter() - t0
    a_specs = sharding.params_sharding_tree(actor, rules)
    per = sharding.params_sharding_tree(tree_map(lambda l: l[0], q), rules)
    on_pod = [("pod",) + s for s in _spec_leaves(per)]
    state = sum(_leaf_bytes(l, s, rules) for l, s in
                zip(tree_leaves(actor), _spec_leaves(a_specs)))
    state += 2 * sum(_leaf_bytes(l, s, rules) for l, s in
                     zip(tree_leaves(q), on_pod))     # q and its target
    return {"mode": "spreeze_arch_update", "arch": arch, "mesh": "2x16x16",
            "batch": batch, "seq": seq, "act_dim": act_dim,
            "flops_per_device": census.flops,
            "bytes_per_device": census.bytes,
            "collective_bytes_per_device": None,
            "collective_breakdown": None,
            "peak_memory_per_device": float(census.peak_bytes),
            "fits_one_card": census.peak_bytes <= analysis.HBM_BYTES,
            "params_bytes_per_device_2x16x16": state,
            "lower_s": round(t_run, 1), "census": census.summary(),
            "notes": "one card runs all five towers (no collective); the "
                     "reference's rules give params_bytes_per_device",
            "card": analysis.CARD}


def lower_spreeze_sampler(*, env_name: str = "pendulum",
                          num_envs: int = 4096, chunk_len: int = 32
                          ) -> Dict[str, Any]:
    """Pod-scale experience sampling: ``num_envs`` envs stepped ``chunk_len``
    times under the SAC actor, on the meta device. The reference splits
    the envs over (pod, data), 32 groups each stepping its shard under its
    replica of the actor with nothing crossing; the port samples on one
    device, so ``flops_per_device`` is the chunk's FLOPs over the 32
    groups and no collective is measured."""
    from repro_torch.envs import base as env_base
    from repro_torch.rl.base import AlgoHP, get_algo
    env = env_base.make(env_name)
    hp = AlgoHP(algo="sac")
    mod = get_algo("sac")
    act = mod.make_act(hp)
    gen = torch.Generator().manual_seed(0)
    actor = mod.init_state(gen, env.spec.obs_dim, env.spec.act_dim, hp,
                           device=META).actor
    states = tree_map(lambda t: t.to(META), env.reset_batch(num_envs, gen))
    reset = tree_map(lambda t: t.to(META), env.reset_draws(num_envs, gen))
    eps = torch.empty((num_envs, env.spec.act_dim), device=META)
    groups = make_production_mesh(multi_pod=True).shape
    groups = groups["pod"] * groups["data"]
    with torch.no_grad(), analysis.OpCensus((actor, states)) as census:
        for _ in range(chunk_len):
            obs = env.observe(states)
            a = act(actor, obs, eps)
            states, nobs, rew, done = env.autoreset_step(states, a, reset)
    return {"mode": "spreeze_sampler", "env": env_name,
            "num_envs": num_envs, "chunk_len": chunk_len, "mesh": "2x16x16",
            "flops_per_device": census.flops / groups,
            "collective_bytes_per_device": None, "collective_count": 0,
            "census": census.summary(),
            "notes": f"the envs over {groups} groups as the reference "
                     "splits them; the port steps them on one device",
            "card": analysis.CARD}


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

def _write(out_dir: str, name: str, rec: Dict) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--spreeze", action="store_true")
    ap.add_argument("--spreeze-batch", type=int, default=8192)
    ap.add_argument("--spreeze-arch", default=None, metavar="ARCH",
                    help="the RLHF-scale AC update with this assigned "
                         "arch as actor/critic backbone")
    ap.add_argument("--spreeze-sampler", action="store_true",
                    help="the pod-scale vmapped env sampler chunk")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="no sequence (context) split in the rules")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="TP-resident weights (decode optimization)")
    ap.add_argument("--data", type=int, default=16,
                    help="intra-pod data-axis size (data*model == 256)")
    ap.add_argument("--model", type=int, default=16)
    ap.add_argument("--tag", default="",
                    help="variant label; JSON written as <pair>_<tag>.json")
    ap.add_argument("--out", default=REPORT_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.spreeze_arch:
        rec = lower_spreeze_arch(args.spreeze_arch)
        print(json.dumps(rec, indent=2))
        _write(args.out, f"spreeze_arch_{args.spreeze_arch}.json", rec)
        return 0
    if args.spreeze_sampler:
        rec = lower_spreeze_sampler()
        print(json.dumps(rec, indent=2))
        _write(args.out, "spreeze_sampler.json", rec)
        return 0
    if args.spreeze:
        for placement in ("ac", "dp"):
            rec = lower_spreeze(multi_pod=True, placement=placement,
                                batch_size=args.spreeze_batch)
            print(json.dumps(rec, indent=2))
            _write(args.out, f"spreeze_rl_{placement}.json", rec)
        return 0

    if args.all:
        pairs = [(a, s) for a in sorted(ARCHS) for s in
                 ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch+--shape or --all or --spreeze required")

    failures = 0
    for arch, shape in pairs:
        mesh_name = (f"2x{args.data}x{args.model}" if args.multipod
                     else f"{args.data}x{args.model}")
        tag = f"{arch}_{shape}_{mesh_name}"
        if args.tag:
            tag += f"_{args.tag}"
        try:
            rec = lower_pair(arch, shape, multi_pod=args.multipod,
                             seq_shard_attn=not args.no_seq_shard,
                             remat=not args.no_remat, data=args.data,
                             model=args.model,
                             fsdp=False if args.no_fsdp else None,
                             tag=args.tag)
            status = ("SKIP: " + rec["skipped"]) if "skipped" in rec else (
                f"ok  compute={rec['compute_s']:.3e}s "
                f"memory={rec['memory_s']:.3e}s "
                f"bottleneck={rec['bottleneck']} "
                f"peak={rec['peak_memory_per_device'] / 2**30:.2f}GiB "
                f"state/dev={rec['state_bytes_per_device'] / 2**30:.2f}GiB "
                f"run={rec['lower_s']}s")
            print(f"[{tag}] {status}", flush=True)
        except Exception as e:                  # a pair's failure is data
            failures += 1
            rec = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[{tag}] FAIL {e}", flush=True)
        _write(args.out, tag + ".json", rec)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
