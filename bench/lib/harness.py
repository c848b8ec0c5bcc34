"""One run of one cell, driven by the data in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. The configuration's file
(``configs[].file``) names its ``runner`` (``bench/runners/<runner>.py``),
the code that builds the program's objects and runs its timed path; the
traffic mix is ``bench/traffic/<traffic>.json``, which also holds the
limits of the cell's ``correct``; each metric is read by
``bench/metrics/<metric>.py``. Nothing here names a cell, a mix or a
metric, so a later change adds them as files and entries.

The run: set-up (``setup_s`` ends here), the timed window, with
``--trace 1`` a profiled sub-window after it, the device memory peak,
the program's state freed, then the reference and the comparison.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from bench.lib.trace import Trace, Tracer

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """What a metric's reader sees."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: dict                      # the runner's counts of the window
    trace: Optional[Trace] = None     # the profiled sub-window
    traced: dict = field(default_factory=dict)   # the runner's counts of it


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def load_metric(name: str) -> Callable[[Context], Optional[float]]:
    """``bench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, moves_of_cell=None) -> bool:
    """A metric is read in the cells its ``workloads`` list, or without
    the key in every cell (a per-layer metric: every cell that reports
    the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_of_cell is None or metric["moves"] in moves_of_cell


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_parts(name: str, root: str = ROOT, overrides: Optional[dict] = None,
               bm: Optional[dict] = None):
    """-> (benchmark, cell entry, configuration, traffic), with
    ``overrides`` ({"config": {...}, "traffic": {...}}) merged in; ``bm``
    in place of the root's ``BENCHMARK.json``."""
    bm = load_benchmark(root) if bm is None else bm
    cell = _by_name(bm["workloads"], name, "workload")
    conf = _by_name(bm["configs"], cell["config"], "config")
    cfg = load_json(root, conf["file"])
    traffic = load_json(root, os.path.join("bench", "traffic",
                                           cell["traffic"] + ".json"))
    for part, extra in (overrides or {}).items():
        (cfg if part == "config" else traffic).update(extra)
    return bm, cell, cfg, traffic


def make_cell(cfg: dict, traffic: dict, seed: int, device):
    runner = importlib.import_module("bench.runners." + cfg["runner"])
    return runner.Cell(cfg, traffic, seed, device)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None,
        overrides: Optional[dict] = None, root: str = ROOT,
        bm: Optional[dict] = None) -> dict:
    """One run of cell ``name`` -> the result object (without the module
    check, which the caller makes once the window has closed)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bm, cell, cfg, traffic = cell_parts(name, root, overrides, bm)
    c = make_cell(cfg, traffic, seed, device)
    c.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    win = c.window(seconds)
    ctx = Context(cell=cell, config=cfg, traffic=traffic, setup_s=setup_s,
                  window=win)
    if trace:
        tracer = Tracer()
        ctx.traced = c.traced(tracer)
        ctx.trace, _ = tracer.run(ctx.traced["block"], lambda: sync(device))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    c.release()
    numbers = c.check()
    limits = traffic["limits"]
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits)

    e2e = [m for m in bm["end_to_end"] if applies(m, name)]
    moves = {m["name"] for m in e2e}
    chosen = ([m for m in bm["per_layer"] if applies(m, name, moves)]
              if trace else e2e)
    metrics = {}
    for m in chosen:
        value = load_metric(m["name"])(ctx)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in ctx.trace.top_ops],
                            "idle_gaps": [list(x)
                                          for x in ctx.trace.idle_gaps]}
    out["check"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                              else str(numbers[k]), "limit": limits[k]}
                    for k in limits}
    return out
