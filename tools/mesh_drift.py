#!/usr/bin/env python3
"""How far two full-width training runs drift apart, megastep by
megastep, when their math differs only in rounding.

    python3 tools/mesh_drift.py

Builds ``SpreezeTrainer`` pairs at the reference's default config
(Pendulum, hidden 256x256, 16 envs x 32 steps, batch 8192, capacity
262,144, K 4, R 4, seed 0) and runs each pair's ``_warmup`` and four
megasteps side by side on the card, printing after each megastep the
largest absolute and relative differences of the actor, the Q stack, the
critic loss and the ring's rows, and whether the parameters are still
within rtol 1e-3, atol 1e-5. The pairs, each against one single-device
trainer of the same seed:

- the same trainer with one actor weight moved by one ulp (the drift the
  training loop itself makes out of a rounding difference);
- mesh trainers on the one-card stand-in (meshes naming cuda:0 at every
  position): ac 2x2 (two groups, Q split over the ac rows), ac 1x1
  (must be bitwise equal), ac 2x1 (the Q split alone), dp 1x2 (the batch
  split alone), and TD3 on dp 2x2.

Then SAC PER on an ac 2x2 mesh against its twin in lock step: each of
``PER_ROUNDS`` rounds starts from the twin's whole carry (state, ring,
priorities, env states, draw state), and the line reports, for each of
the round's four updates, whether it drew the twin's rows in the twin's
order, and the actor's largest difference after the round.

Prints the card line first and one JSON line a megastep (a round for the
PER lock step). Needs a CUDA device.
"""
import json
import os
import sys
import time

from device_profile import card_line

MEGASTEPS = 4
PER_ROUNDS = 8


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("mesh_drift: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.core import model_parallel as mp
    from repro_torch.launch.mesh import make_ac_mesh
    from repro_torch.rl import AlgoHP

    print(card_line(), flush=True)

    def cfg(**kw):
        base = dict(num_envs=16, batch_size=8192, replay_capacity=262144,
                    warmup_frames=2048, chunk_len=32, updates_per_round=4,
                    rounds_per_dispatch=4, eval_every_rounds=10**9, seed=0,
                    hp=AlgoHP(hidden=(256, 256)), device="cuda")
        return SpreezeConfig(**{**base, **kw})

    def diff(a, b):
        worst, rel = 0.0, 0.0
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            d = (x - y).abs()
            worst = max(worst, float(d.max()))
            rel = max(rel, float((d / (y.abs() + 1e-30)).max()))
        return worst, rel

    def mesh(ac, batch):
        return make_ac_mesh(ac, batch, devices=["cuda:0"] * (ac * batch))

    pairs = (("one ulp on an actor weight", {}, "sac", True),
             ("mesh ac 2x2", dict(mesh=mesh(2, 2), placement="ac"), "sac",
              False),
             ("mesh ac 1x1", dict(mesh=mesh(1, 1), placement="ac"), "sac",
              False),
             ("mesh ac 2x1", dict(mesh=mesh(2, 1), placement="ac"), "sac",
              False),
             ("mesh dp 1x2", dict(mesh=mesh(1, 2), placement="dp"), "sac",
              False),
             ("TD3 mesh dp 2x2", dict(mesh=mesh(2, 2), placement="dp"),
              "td3", False))
    t0 = time.perf_counter()
    for label, kw, algo, nudge in pairs:
        one = SpreezeTrainer(cfg(algo=algo))
        other = SpreezeTrainer(cfg(algo=algo, **kw))
        if nudge:
            w = other.state.actor["l0"]["w"].view(-1)
            w[0] = torch.nextafter(w[0], torch.ones((), device="cuda"))
        for tr in (one, other):
            tr._warmup()
        for m in range(MEGASTEPS):
            one.megastep()
            other.megastep()
            sa, sb = mp.whole_state(other), mp.whole_state(one)
            ra, rb = mp.whole_replay(other), mp.whole_replay(one)
            out = {k: diff(getattr(sa, k), getattr(sb, k))
                   for k in ("actor", "q")}
            out["critic_loss"] = diff(other.last_metrics["critic_loss"],
                                      one.last_metrics["critic_loss"])
            out["rows"] = diff(ra.data, rb.data)
            out["within_tolerance"] = all(
                torch.allclose(x, y, rtol=1e-3, atol=1e-5)
                for k in ("actor", "q")
                for x, y in zip(tree_leaves(getattr(sa, k)),
                                tree_leaves(getattr(sb, k))))
            print(json.dumps({"pair": label, "megastep": m + 1, **out}),
                  flush=True)
        del one, other
        torch.cuda.empty_cache()
    from repro_torch._tree import tree_map
    from repro_torch.replay import prioritized as per
    drawn, sample = {True: [], False: []}, per.sample

    def recording(state, gumbel, batch_size, **kw):
        out = sample(state, gumbel, batch_size, **kw)
        drawn[kw.get("rules") is not None].append(out[1].clone())
        return out

    per.sample = recording
    kw = dict(prioritized=True)
    one = SpreezeTrainer(cfg(**kw))
    other = SpreezeTrainer(cfg(mesh=mesh(2, 2), placement="ac", **kw))
    for tr in (one, other):
        tr._warmup()
    for r in range(PER_ROUNDS):
        other.state = mp.place_state(one.state, other.layout)
        other.replay = mp.place_replay(one.replay, other.layout)
        other.env_states = tree_map(torch.clone, one.env_states)
        other.draws.set_state(one.draws.get_state())
        for v in drawn.values():
            v.clear()
        other.megastep(rounds=1)
        one.megastep(rounds=1)
        print(json.dumps({
            "pair": "SAC PER mesh ac 2x2, lock step", "round": r + 1,
            "update_draws_equal": [bool(torch.equal(a, b)) for a, b in
                                   zip(drawn[True], drawn[False])],
            "actor": diff(mp.whole_state(other).actor, one.state.actor)}),
            flush=True)
    per.sample = sample
    print(f"mesh_drift: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
