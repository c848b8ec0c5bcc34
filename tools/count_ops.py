#!/usr/bin/env python3
"""How many PyTorch ops the training path dispatches, by algorithm.

    PYTHONPATH=src python3 tools/count_ops.py

Runs on the CPU (a count, not a time: the same code dispatches the same
ops on the card, where the megastep is host-bound and each op costs
host time). For SAC, TD3 and DDPG under uniform replay, and SAC and
DDPG under prioritized replay, it builds a small ``SpreezeTrainer``
(hidden 32x32, batch 64; the counts do not depend on the widths), warms
it up, and counts the ATen ops dispatched by an update round (per
update), a sampler chunk (per env step) and a megastep (4 rounds of 4
updates), and the ops of the megastep's finite guard (``carry_finite``,
two reductions an actor leaf and a metric and two to join them; on the
card ``train()`` adds one copy of the flag to pinned host memory and an
event). Prints one JSON line per configuration.
"""
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with OpCount() as c:
        fn()
    return c.n


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.core import SpreezeConfig, SpreezeTrainer, faults
    from repro_torch.rl import AlgoHP
    for algo, prioritized in (("sac", False), ("td3", False),
                              ("ddpg", False), ("sac", True),
                              ("ddpg", True)):
        cfg = SpreezeConfig(algo=algo, prioritized=prioritized, num_envs=4,
                            chunk_len=8, batch_size=64,
                            replay_capacity=1000, warmup_frames=64,
                            updates_per_round=4, rounds_per_dispatch=4,
                            hp=AlgoHP(hidden=(32, 32)), device="cpu")
        tr = SpreezeTrainer(cfg)
        tr._warmup()
        tr.megastep()
        print(json.dumps({
            "algo": algo, "replay": "PER" if prioritized else "uniform",
            "ops_per_update": count(lambda: tr.update_round(
                tr.state, tr.replay)) / cfg.updates_per_round,
            "ops_per_sampler_step": count(lambda: tr.sampler_chunk(
                tr.state.actor, tr.env_states)) / cfg.chunk_len,
            "ops_per_megastep": count(tr.megastep),
            "ops_finite_guard": count(lambda: faults.tree_finite(
                (tr.state.actor, {k: tr.last_metrics[k] for k in
                                  ("mean_rew", "critic_loss")})))}),
            flush=True)


if __name__ == "__main__":
    main()
