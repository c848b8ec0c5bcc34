#!/usr/bin/env python3
"""Which layer of a training round makes the host wait for the card.

    python3 tools/probe_waits.py

For each layer (the draws, a sampler chunk, the ring write, a sample,
an update, an update round, a megastep, the finite guard and its
pinned copy), it synchronises, queues a ~1 s spin kernel on the train
stream, runs the layer and reports the host time the call took, whether
the spin was still running when it returned, and the PyTorch ops the
layer dispatches (counted as ``tools/count_ops.py`` counts them). A
layer that returns with the spin finished waited for the card: either
it synchronises, or it queued more launches than the card's launch
queue holds, so the host waited for room. Runs at a small size (hidden
64, batch 64) and at the reference's full widths. Prints one JSON line
a layer, with the card's name and power limit. Needs a CUDA device.
"""
import json
import os
import sys
import time

from count_ops import count


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_waits: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch import card_line
    from repro_torch.core import SpreezeConfig, SpreezeTrainer, faults
    from repro_torch.replay import buffer as rb
    from repro_torch.rl import AlgoHP

    card = card_line("cuda")

    def probe(size, name, fn):
        ops = count(fn)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        spun = torch.cuda.Event()
        spun.record()
        t = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t) * 1e3
        waited = spun.query()
        torch.cuda.synchronize()
        print(json.dumps({"size": size, "layer": name, "ops": ops,
                          "host_ms": host_ms, "waited_for_the_card": waited,
                          "card": card}), flush=True)

    sizes = {"small": dict(num_envs=4, chunk_len=8, batch_size=64,
                           replay_capacity=256, warmup_frames=64,
                           updates_per_round=2, rounds_per_dispatch=2,
                           hp=AlgoHP(hidden=(64, 64))),
             "full": dict(hp=AlgoHP(hidden=(256, 256)))}
    for size, kw in sizes.items():
        cfg = SpreezeConfig(**kw)
        tr = SpreezeTrainer(cfg)
        tr._warmup()
        tr.megastep()
        act_dim = tr.env.spec.act_dim
        _, flat, _ = tr.sampler_chunk(tr.state.actor, tr.env_states)
        idx, *eps = tr.draws.update(tr.replay, cfg.batch_size, act_dim)
        batch = rb.sample(tr.replay, idx)
        for name, fn in (
                ("draws.sampler_step",
                 lambda: tr.draws.sampler_step(cfg.num_envs, act_dim)),
                ("sampler_chunk",
                 lambda: tr.sampler_chunk(tr.state.actor, tr.env_states)),
                ("transfer.push", lambda: tr.transfer.push(tr.replay, flat)),
                ("draws.update", lambda: tr.draws.update(
                    tr.replay, cfg.batch_size, act_dim)),
                ("rb.sample", lambda: rb.sample(tr.replay, idx)),
                ("update", lambda: tr._update(tr.state, batch, *eps)),
                ("update_round", lambda: tr.update_round(tr.state,
                                                         tr.replay)),
                ("megastep", tr.megastep),
                ("finite guard + pinned copy", lambda: tr._guard_entry(
                    0, faults.tree_finite((tr.state.actor,
                                           tr.last_metrics))))):
            probe(size, name, fn)
        del tr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
