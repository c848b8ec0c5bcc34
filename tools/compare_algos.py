#!/usr/bin/env python3
"""SAC, TD3 and DDPG on the card, in turns.

    python3 tools/compare_algos.py

Builds three ``SpreezeTrainer``s at the reference's full widths (the
configuration ``chip_smoke.py`` trains: hidden 256x256, batch 8192,
capacity 262144, 16 envs x 32 steps, 4 updates a round, 4 rounds a
megastep), with uniform replay and SAC, TD3 and DDPG, and warms each up.
Then it times, with the device synchronised around each, a sampler
chunk, an update round and a megastep of each, in the order SAC, TD3,
DDPG, DDPG, TD3, SAC, repeated, so that a drift of the host's speed
falls on all three alike. Prints one JSON line of medians (and every
sample) beside the card's name and power limit. Needs a CUDA device.
"""
import json
import os
import statistics
import sys
import time

from device_profile import card_line

CYCLES = 4
ALGOS = ("sac", "td3", "ddpg")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_algos: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP

    def timed(fn, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    trainers = {}
    for algo in ALGOS:
        tr = SpreezeTrainer(SpreezeConfig(algo=algo,
                                          hp=AlgoHP(hidden=(256, 256))))
        tr._warmup()
        tr.megastep()                    # first calls: allocator, cuBLAS
        trainers[algo] = tr

    samples = {}
    for _ in range(CYCLES):
        for algo in ALGOS + ALGOS[::-1]:
            tr = trainers[algo]

            def sampler(tr=tr):
                tr.env_states = tr.sampler_chunk(tr.state.actor,
                                                 tr.env_states)[0]

            for name, fn, reps in (
                    ("sampler_chunk", sampler, 2),
                    ("update_round",
                     lambda: tr.update_round(tr.state, tr.replay), 2),
                    ("megastep", tr.megastep, 1)):
                samples.setdefault(f"{algo}_{name}_ms", []).append(
                    timed(fn, reps))
    medians = {k: statistics.median(v) for k, v in samples.items()}
    for algo in ("td3", "ddpg"):
        for name in ("update_round", "megastep"):
            medians[f"{algo}_over_sac_{name}"] = (
                medians[f"{algo}_{name}_ms"] / medians[f"sac_{name}_ms"])
    print(json.dumps({"card": card_line(), "cycles": CYCLES,
                      "medians": medians, "samples": samples}))


if __name__ == "__main__":
    main()
