#!/usr/bin/env python3
"""Uniform against prioritized replay on the card, in turns.

    python3 tools/compare_replay.py

Builds two ``SpreezeTrainer``s at the reference's full widths (the
configuration ``chip_smoke.py`` trains: hidden 256x256, batch 8192,
capacity 262144, 16 envs x 32 steps, 4 updates a round, 4 rounds a
megastep), one with uniform replay and one with prioritized replay
(alpha 0.6, beta 0.4), and warms both up. Then it times, with the device
synchronised around each, the parts of one update (draws, sample, SAC
step, and under PER the re-prioritisation), an update round and a
megastep of each, in the order uniform, PER, PER, uniform, repeated, so
that a drift of the host's speed falls on both alike. Prints one JSON
line of medians (and every sample) beside the card's name and power
limit. Needs a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys
import time

CYCLES = 4


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_replay: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.replay import buffer as rb
    from repro_torch.replay import prioritized as per
    from repro_torch.rl import AlgoHP

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    def timed(fn, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    def parts(tr):
        """name -> a callable timing one piece of an update."""
        cfg, act_dim = tr.cfg, tr.env.spec.act_dim
        b = cfg.batch_size
        if cfg.prioritized:
            gumbel, e1, e2 = tr.draws.per_update(cfg.replay_capacity, b,
                                                 act_dim)
            batch, idx, w = per.sample(tr.replay, gumbel, b,
                                       alpha=cfg.per_alpha,
                                       beta=cfg.per_beta)
            batch["weight"] = w
            td = tr._update(tr.state, batch, e1, e2)[1]["td_abs"]
            return {
                "draws": lambda: tr.draws.per_update(cfg.replay_capacity,
                                                     b, act_dim),
                "sample": lambda: per.sample(tr.replay, gumbel, b,
                                             alpha=cfg.per_alpha,
                                             beta=cfg.per_beta),
                "sac_update": lambda: tr._update(tr.state, batch, e1, e2),
                "reprioritise": lambda: per.update_priorities(tr.replay,
                                                              idx, td)}
        idx, e1, e2 = tr.draws.update(tr.replay, b, act_dim)
        batch = rb.sample(tr.replay, idx)
        return {"draws": lambda: tr.draws.update(tr.replay, b, act_dim),
                "sample": lambda: rb.sample(tr.replay, idx),
                "sac_update": lambda: tr._update(tr.state, batch, e1, e2)}

    trainers = {}
    for label, prioritized in (("uniform", False), ("per", True)):
        tr = SpreezeTrainer(SpreezeConfig(hp=AlgoHP(hidden=(256, 256)),
                                          prioritized=prioritized))
        tr._warmup()
        tr.megastep()                    # first calls: allocator, cuBLAS
        trainers[label] = tr
    pieces = {label: parts(tr) for label, tr in trainers.items()}

    samples = {}
    for _ in range(CYCLES):
        for label in ("uniform", "per", "per", "uniform"):
            tr = trainers[label]
            for name, fn in pieces[label].items():
                samples.setdefault(f"{label}_{name}_ms", []).append(
                    timed(fn, 8))
            samples.setdefault(f"{label}_update_round_ms", []).append(
                timed(lambda: tr.update_round(tr.state, tr.replay), 2))
            samples.setdefault(f"{label}_megastep_ms", []).append(
                timed(tr.megastep, 1))
    medians = {k: statistics.median(v) for k, v in samples.items()}
    medians["per_over_uniform_update_round"] = (
        medians["per_update_round_ms"] / medians["uniform_update_round_ms"])
    medians["per_over_uniform_megastep"] = (
        medians["per_megastep_ms"] / medians["uniform_megastep_ms"])
    out = {"card": card, "cycles": CYCLES, "medians": medians,
           "samples": samples}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
