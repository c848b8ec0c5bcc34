"""Replay-ring kernel bench: the kernels against the row-at-a-time
baselines and the plain versions, each checked first.

Counterpart of ``benchmarks/bench_replay_kernels.py``. Four tables, each
with its arms:

* ``ring_write``: ``kernel`` (``ring_write``), ``rowloop``
  (``ring_write_rowloop``: the same coalesced kernel with a floor
  remainder, so no longer a row-at-a-time write), ``plain``
  (``ring_write_ref``); a write of n rows that wraps at the ring's end
  mid-batch;
* ``ring_gather``: ``kernel`` (``ring_gather``), ``rowloop``
  (``ring_gather_rowloop``: the same blocked kernel with the clamping
  index rule, so no longer a row-at-a-time gather), ``plain``
  (``ring_gather_ref``) over B uniform indices;
* ``per_scores``: ``kernel`` and ``plain`` over a half-empty pool (the
  ``-inf`` path runs);
* ``per_topk``: ``kernel`` (the fused ``per_topk``), ``global_topk`` (the
  ``per_scores`` kernel, then ``torch.topk``), ``plain``
  (``per_topk_ref``); then the two-phase check: ``per_topk`` over 4
  windows of the pool, merged with ``merge_topk_candidates``, must equal
  the dense top-k.

With a mesh (``mesh_devices``: eight devices, which may repeat, or eight
visible CUDA devices) ``per_scores`` and ``per_topk`` each get a
``sharded`` arm: the pool split into the batch groups' shards of
``trainer_rules(make_ac_mesh(2, 4, devices=...), "ac")`` (4 groups, the
reference's bench mesh), ``per_scores_sharded`` / ``per_topk_sharded``
over them, checked against the plain version as the other arms are.

Every arm goes through ``repro_torch.kernels.ops``, so the operands'
device picks the kernels (``cuda``) or the plain versions (``cpu``), and
is held against its plain version before it is timed: bit for bit, and
for ``global_topk`` the scores bit for bit and the indices on the finite
slots (``torch.topk`` leaves the order of ties unspecified). A mismatch
exits non-zero. On the card each arm is timed with CUDA events over
``iters`` calls after ``WARMUP``; on the CPU with the host clock, which
times PyTorch's CPU kernels and nothing of the card.

One JSON line per table, then one with the config and ``oracle_ok``; the
whole report goes to ``--out`` (by default under ``build/``).

Run:
  python -m repro_torch.benchmarks.replay_kernels [--tiny]
  python -m repro_torch.benchmarks.replay_kernels --tiny --device cpu

On the card one run launches each arm's kernel 1 + WARMUP + iters times
(the check, the warm-up, the timed calls), ``per_scores`` twice that
(its own table and ``global_topk``), and ``per_topk`` 4 more times (the
two-phase check), and each sharded arm its kernel once a group a call.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch import card_line, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops
from repro_torch.kernels._build import REPO_ROOT

MESH_DEVICES = 8         # the sharded arms' (2, 4) mesh

# capacity, write rows, gather rows, features, top-k, timed calls
PRESETS = {"full": dict(cap=16384, n=1024, bsz=1024, feat=16, k=256,
                        iters=100),
           "tiny": dict(cap=2048, n=256, bsz=256, feat=8, k=64, iters=10)}
WARMUP = 5
ALPHA = 0.6
WINDOWS = 4
DEFAULT_OUT = os.path.join(REPO_ROOT, "build", "replay_kernels.json")


def _ms(fn, dev, iters) -> float:
    """Milliseconds a call: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(WARMUP):
        fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e3


def _check(name: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    ok = got.shape == want.shape and bool(torch.equal(got, want))
    if not ok:
        print(f"ORACLE MISMATCH in {name}", file=sys.stderr)
    return ok


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _pool(dev, cap, seed):
    """A half-empty priority vector (a written row holds u + 0.1) and a
    Gumbel field, as the JAX bench draws them."""
    g = _gen(dev, seed)
    u = torch.rand(cap, generator=g, device=dev)
    pri = torch.where(u > 0.5, u + 0.1, torch.zeros((), device=dev))
    e = torch.rand(cap, generator=g, device=dev).clamp_(min=1e-12)
    return pri, -torch.log(-torch.log(e))


def bench_ring_write(dev, cap, n, feat, iters):
    g = _gen(dev, 0)
    data = torch.randn((cap, feat), generator=g, device=dev)
    batch = torch.randn((n, feat), generator=g, device=dev)
    ptr = torch.tensor(cap - n // 2, dtype=torch.int32, device=dev)
    want = rops.ring_write_ref(data.clone(), batch, ptr)
    arms = {"kernel": kops.ring_write, "rowloop": kops.ring_write_rowloop,
            "plain": rops.ring_write_ref}
    rec, ok, buf = {}, True, data.clone()
    for name, fn in arms.items():
        ok &= _check(f"ring_write/{name}", fn(data.clone(), batch, ptr), want)
        rec[f"{name}_ms"] = _ms(lambda fn=fn: fn(buf, batch, ptr), dev, iters)
    return rec, ok


def bench_ring_gather(dev, cap, bsz, feat, iters):
    g = _gen(dev, 1)
    data = torch.randn((cap, feat), generator=g, device=dev)
    idx = torch.randint(0, cap, (bsz,), generator=g, device=dev,
                        dtype=torch.int32)
    want = rops.ring_gather_ref(data, idx)
    arms = {"kernel": kops.ring_gather, "rowloop": kops.ring_gather_rowloop,
            "plain": rops.ring_gather_ref}
    rec, ok = {}, True
    for name, fn in arms.items():
        ok &= _check(f"ring_gather/{name}", fn(data, idx), want)
        rec[f"{name}_ms"] = _ms(lambda fn=fn: fn(data, idx), dev, iters)
    return rec, ok


def mesh_rules(devices):
    """The sharded arms' rules: placement "ac" over a (2, 4) mesh."""
    from repro_torch.distributed.sharding import trainer_rules
    from repro_torch.launch.mesh import make_ac_mesh
    return trainer_rules(make_ac_mesh(2, 4, devices=devices), "ac")


def _shards(x, rules):
    """``x`` split into the batch groups' contiguous shards, each a copy
    on its group's device."""
    from repro_torch.distributed.sharding import group_devices, to_group
    devs = group_devices(rules)
    rows = x.shape[0] // len(devs)
    return [to_group(x.narrow(0, g * rows, rows), d, copy=True)
            for g, d in enumerate(devs)]


def _whole(parts, dev):
    from repro_torch.distributed.sharding import to_group
    return torch.cat([to_group(p, dev) for p in parts])


def bench_per_scores(dev, cap, iters, rules=None):
    pri, gumbel = _pool(dev, cap, 2)
    want = rops.per_scores_ref(pri, gumbel, ALPHA)
    arms = {"kernel": kops.per_scores, "plain": rops.per_scores_ref}
    if rules is not None:
        shards = _shards(pri, rules)
        arms["sharded"] = lambda p, g, a: _whole(
            kops.per_scores_sharded(shards, g, a, rules), dev)
    rec, ok = {}, True
    for name, fn in arms.items():
        ok &= _check(f"per_scores/{name}", fn(pri, gumbel, ALPHA), want)
        rec[f"{name}_ms"] = _ms(lambda fn=fn: fn(pri, gumbel, ALPHA), dev,
                                iters)
    return rec, ok


def _global_topk(pri, gumbel, k):
    v, i = torch.topk(kops.per_scores(pri, gumbel, ALPHA), k)
    return v, i.to(torch.int32)


def bench_per_topk(dev, cap, k, iters, rules=None):
    pri, gumbel = _pool(dev, cap, 3)
    want_v, want_i = rops.per_topk_ref(pri, gumbel, ALPHA, k)
    fin = torch.isfinite(want_v)

    def check_sel(name, got):
        v, i = got
        ok = _check(f"per_topk/{name}/scores", v, want_v)
        return ok & _check(f"per_topk/{name}/idx", i[fin], want_i[fin])

    arms = {"kernel": lambda p, g: kops.per_topk(p, g, ALPHA, k),
            "global_topk": lambda p, g: _global_topk(p, g, k),
            "plain": lambda p, g: rops.per_topk_ref(p, g, ALPHA, k)}
    if rules is not None:
        shards = _shards(pri, rules)
        arms["sharded"] = lambda p, g: kops.per_topk_sharded(
            shards, g, ALPHA, k, rules)
    rec, ok = {}, True
    for name, fn in arms.items():
        ok &= check_sel(name, fn(pri, gumbel))
        rec[f"{name}_ms"] = _ms(lambda fn=fn: fn(pri, gumbel), dev, iters)

    # two-phase: window-local top-k's merged in window order must equal
    # the dense top-k (the reference's layout-invariance identity)
    rows = cap // WINDOWS
    cand = [kops.per_topk(pri[lo:lo + rows], gumbel[lo:lo + rows], ALPHA, k,
                          window_start=lo) for lo in range(0, cap, rows)]
    merged = rops.merge_topk_candidates(torch.cat([c[0] for c in cand]),
                                        torch.cat([c[1] for c in cand]), k)
    two_phase_ok = check_sel("two_phase_merge", merged)
    rec["two_phase_ok"] = bool(two_phase_ok)
    return rec, ok & two_phase_ok


def run(tiny: bool = False, device="cuda", mesh_devices=None):
    """Runs every table; returns ``(report, oracle_ok)``. The sharded arms
    run over ``mesh_devices`` (eight), or over the visible CUDA devices
    when ``device`` is a card and there are eight."""
    dev = resolve_device(device)
    p = PRESETS["tiny" if tiny else "full"]
    if (mesh_devices is None and dev.type == "cuda"
            and torch.cuda.device_count() >= MESH_DEVICES):
        mesh_devices = [torch.device("cuda", i)
                        for i in range(MESH_DEVICES)]
    rules = None if mesh_devices is None else mesh_rules(mesh_devices)
    cfg = {"capacity": p["cap"], "write_rows": p["n"],
           "gather_rows": p["bsz"], "features": p["feat"], "topk": p["k"],
           "iters": p["iters"], "warmup": WARMUP, "tiny": tiny,
           "device": card_line(dev),
           "timer": "cuda events" if dev.type == "cuda" else "host clock",
           "mesh": None if rules is None else repr(rules.mesh)}
    tables = {
        "ring_write": bench_ring_write(dev, p["cap"], p["n"], p["feat"],
                                       p["iters"]),
        "ring_gather": bench_ring_gather(dev, p["cap"], p["bsz"], p["feat"],
                                         p["iters"]),
        "per_scores": bench_per_scores(dev, p["cap"], p["iters"], rules),
        "per_topk": bench_per_topk(dev, p["cap"], p["k"], p["iters"],
                                   rules),
    }
    oracle_ok = all(ok for _, ok in tables.values())
    report = {"config": cfg, **{name: rec for name, (rec, _) in
                                tables.items()}, "oracle_ok": oracle_ok}
    return report, oracle_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="the smoke preset (small shapes, fewer calls)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-devices", default=None, metavar="DEV,...",
                    help="the eight devices of the sharded arms' mesh, "
                         "comma-separated (a device may repeat)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    report, oracle_ok = run(args.tiny, args.device,
                            args.mesh_devices.split(",")
                            if args.mesh_devices else None)
    for name in ("ring_write", "ring_gather", "per_scores", "per_topk"):
        print(json.dumps({"table": "replay_kernels", "name": name,
                          **report[name]}), flush=True)
    print(json.dumps({"table": "replay_kernels", "name": "oracle",
                      "ok": oracle_ok, **report["config"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    return 0 if oracle_ok else 1


if __name__ == "__main__":
    sys.exit(main())
