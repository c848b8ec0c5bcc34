#!/usr/bin/env python3
"""Runs the PyTorch port (``src/repro_torch``) on one CUDA card and
checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):
  1. the card's name and power limit, and the float32 matmul settings;
  2. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` (timed);
  3. hold each kernel against its plain PyTorch version on the card at
     the training path's shapes (max abs error must be 0: the ring ops and
     the scatter copy, the top-k selects), then time kernel, plain
     version and the library call with CUDA events;
  4. port on the card against port on the CPU, same start state and same
     draws, small sizes, uniform and prioritized replay: every replay
     row, priority, counter and parameter agrees;
  5. drive ``SpreezeTrainer.train`` at the reference's full widths
     (hidden 256x256, batch 8192, capacity 262144, 16 envs x 32 steps,
     4 updates a round, 4 rounds a megastep), once with uniform replay and
     once with prioritized replay (alpha 0.6, beta 0.4), with the launch
     counters reset just before each run and read just after: each kernel
     must have been launched exactly as often as the path implies;
  6. time the layers of one round at full width (sampler chunk, ring
     write, SAC update) with CUDA synchronisation around each, for both
     paths, and the parts of one PER update;
  7. hold the LM model kernels (rmsnorm, flash_attention,
     decode_attention) against their plain versions on the card at the
     serving path's shapes, in float32 (max abs error <= 1e-5: the
     reduction order differs) and bfloat16 (within one bf16 rounding step
     of the plain result: 2**-7 relative, plus the float32 1e-5), then time
     kernel, plain version and the library call (``F.rms_norm``,
     ``F.scaled_dot_product_attention``), timing only; the same for
     ``ssd_scan`` at full-width mamba2-130m's and zamba2-1.2b's prefill
     shapes, a ragged single chunk and a small shape (float32 within 1e-5
     of the largest |plain|, since the scan's sums run over N and the
     chunk; bfloat16 one rounding step more), timed with no library call
     (no PyTorch call computes the scan);
  8. serve on the card against serving on the CPU, same parameters and
     prompts at float32 compute, prefill plus 8 decode steps: reduced
     qwen2-0.5b, reduced mamba2-130m and reduced zamba2-1.2b (5 layers);
     the logits agree within 1e-4 of the largest and the tokens are
     identical;
  9. serve full-width qwen2-0.5b, mamba2-130m and zamba2-1.2b (random
     weights from seed 0, bf16 compute) through
     ``repro_torch.serve.engine.greedy_generate``: 8 prompts of 1024
     tokens, 64 new tokens each, each with the launch counters reset just
     before and read just after (``SERVE_LAUNCHES``); then time the
     prefill and the decode step.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12           # dense tensor-core bf16, same sheet
FIELD_WIDTHS = {"obs": 3, "act": 1, "rew": 1, "next_obs": 3, "done": 1,
                "disc": 1}          # the six replay fields, Pendulum
CAPACITY, ROUND_ROWS, BATCH = 262_144, 16 * 32, 8192
ALPHA = 0.6                          # SpreezeConfig.per_alpha
# the serving path: qwen2-0.5b, 8 prompts of 1024 tokens, 64 new tokens
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "qwen2-0.5b", 8, 1024, 64
HEADS, KV_HEADS, HEAD_DIM, D_MODEL = 14, 2, 64, 896
DECODE_LONG = 32_768                 # the decode_32k cache length
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")
# (B, S, H, P, N, chunk) of each SSM's prefill scan at the serving shape
SCAN_SHAPES = {"mamba2-130m": (SERVE_B, SERVE_PROMPT, 24, 64, 128, 256),
               "zamba2-1.2b": (SERVE_B, SERVE_PROMPT, 64, 64, 64, 256)}
# Exact launches of one greedy_generate at the serving shape (64 new
# tokens: 65 forwards). dense: 2L + 1 norms a forward, L flash (prefill),
# L decode attentions a step. ssm: L pre-norms, L gated norms and ln_f a
# forward, L scans (prefill). hybrid: its 38 core layers as ssm, plus 7
# shared-block calls, each with 2 norms and a flash (prefill) or a decode
# attention (a step): 91 norms a forward.
SERVE_LAUNCHES = {
    "qwen2-0.5b": {"rmsnorm": 3185, "flash_attention": 24,
                   "decode_attention": 1536},
    "mamba2-130m": {"rmsnorm": 3185, "ssd_scan": 24},
    "zamba2-1.2b": {"rmsnorm": 5915, "flash_attention": 7,
                    "decode_attention": 448, "ssd_scan": 38},
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, iters=200, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_ring_write(rops, dev):
    """Kernel vs plain version, every field width, mid-ring, wrapping and
    windowed writes. Returns the max abs error over all cases."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(CAPACITY, 100_000, None), (CAPACITY, CAPACITY - 200, None),
             # a 65536-row window of the ring that the write straddles
             (65_536, 131_072 - 300, 131_072)]
    for rows_local, ptr, lo in cases:
        for width in sorted(set(FIELD_WIDTHS.values())):
            data = torch.randn((rows_local, width), generator=g, device=dev)
            batch = torch.randn((ROUND_ROWS, width), generator=g, device=dev)
            p = torch.tensor(ptr, dtype=torch.int32, device=dev)
            kw = ({} if lo is None else
                  {"capacity": CAPACITY,
                   "window_start": torch.tensor(lo, dtype=torch.int32,
                                                device=dev)})
            got = rops.ring_write(data.clone(), batch, p, **kw)
            want = rops.ring_write_ref(data.clone(), batch, p, **kw)
            require(not torch.equal(got, data), "ring_write wrote nothing")
            worst = max(worst, float((got - want).abs().max()))
    return worst


def check_ring_gather(rops, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for rows_local, lo in ((CAPACITY, None), (65_536, 131_072)):
        base = 0 if lo is None else lo
        for width in sorted(set(FIELD_WIDTHS.values())):
            data = torch.randn((rows_local, width), generator=g, device=dev)
            inside = torch.randint(base, base + rows_local, (BATCH - 64,),
                                   generator=g, device=dev)
            outside = torch.cat([
                torch.full((16,), -1, device=dev),
                torch.randint(0, base + 1, (16,), generator=g,
                              device=dev) - 1,
                torch.randint(base + rows_local, base + 2 * rows_local,
                              (32,), generator=g, device=dev)])
            idx = torch.cat([inside, outside]).to(torch.int32)
            kw = {} if lo is None else {
                "window_start": torch.tensor(lo, dtype=torch.int32,
                                             device=dev)}
            got = rops.ring_gather(data, idx, **kw)
            want = rops.ring_gather_ref(data, idx, **kw)
            require(not got[-64:].any(), "out-of-window rows not zero")
            worst = max(worst, float((got - want).abs().max()))
    return worst


def time_ring_write(rops, dev):
    """Times one round's ring write: the six fields, n = 512 rows each."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    data = {k: torch.randn((CAPACITY, w), generator=g, device=dev)
            for k, w in FIELD_WIDTHS.items()}
    batch = {k: torch.randn((ROUND_ROWS, w), generator=g, device=dev)
             for k, w in FIELD_WIDTHS.items()}
    ptr = torch.tensor(100_000, dtype=torch.int32, device=dev)
    dest = (100_000 + torch.arange(ROUND_ROWS, device=dev)) % CAPACITY

    def kernel():
        for k in data:
            rops.ring_write(data[k], batch[k], ptr)

    def plain():
        for k in data:
            rops.ring_write_ref(data[k], batch[k], ptr)

    def library():
        for k in data:
            data[k].index_copy_(0, dest, batch[k])

    floats = sum(FIELD_WIDTHS.values()) * ROUND_ROWS
    # batch read once + rows written once + ptr read once per field
    moved = 2 * floats * 4 + 4 * len(FIELD_WIDTHS)
    return {"ms": event_ms(kernel), "plain_ms": event_ms(plain),
            "library_ms": event_ms(library),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def time_ring_gather(rops, dev):
    """Times one update's gather: the six fields, B = 8192 uniform rows."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    data = {k: torch.randn((CAPACITY, w), generator=g, device=dev)
            for k, w in FIELD_WIDTHS.items()}
    idx = torch.randint(0, CAPACITY, (BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    idx_long = idx.long()

    def kernel():
        for v in data.values():
            rops.ring_gather(v, idx)

    def plain():
        for v in data.values():
            rops.ring_gather_ref(v, idx)

    def library():
        for v in data.values():
            torch.index_select(v, 0, idx_long)

    unique_rows = int(torch.unique(idx).numel())
    width = sum(FIELD_WIDTHS.values())
    # indices read once, each distinct source row read once, output
    # written once
    moved = BATCH * 4 + unique_rows * width * 4 + BATCH * width * 4
    return {"ms": event_ms(kernel), "plain_ms": event_ms(plain),
            "library_ms": event_ms(library),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def _per_pool(dev, g, rows, live, ties=()):
    """A priority window with ``live`` written rows and a Gumbel field;
    rows in ``ties`` share one priority and one Gumbel value among the
    best scores."""
    import torch
    pri = torch.zeros(rows, device=dev)
    pri[:live] = torch.rand(live, generator=g, device=dev) * 5 + 1e-3
    u = torch.rand(rows, generator=g, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    if ties:
        t = torch.tensor(ties, device=dev)
        pri[t], gumbel[t] = 4.0, 30.0
    return pri, gumbel


def check_per_topk(rops, dev):
    """Kernel vs plain version at the training path's shapes (rows
    262144, k 8192): a full pool, fewer live rows than k, crafted ties
    across tiles, and a window. Returns the max abs error over the finite
    scores and all indices."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    ties = (7, 4095, 4096, 100_000, CAPACITY - 1)
    for rows, live, lo, tie in ((CAPACITY, CAPACITY, None, ()),
                                (CAPACITY, 5000, None, ()),
                                (CAPACITY, CAPACITY, None, ties),
                                (65_536, 65_536, 131_072, ())):
        pri, gumbel = _per_pool(dev, g, rows, live, tie)
        kw = {} if lo is None else {
            "window_start": torch.tensor(lo, dtype=torch.int32,
                                         device=dev)}
        (gs, gi) = rops.per_topk(pri, gumbel, ALPHA, BATCH, **kw)
        (ws, wi) = rops.per_topk_ref(pri, gumbel, ALPHA, BATCH, **kw)
        fin = torch.isfinite(ws)
        require(torch.equal(fin, torch.isfinite(gs)), "per_topk -inf slots")
        require(bool(fin.sum() == min(live, BATCH)), "per_topk live count")
        if tie:
            require(gi[:len(tie)].tolist() == list(tie),
                    "per_topk ties out of index order")
        if live < BATCH:
            require(bool((gi[live:] == rops.IDX_SENTINEL).all()),
                    "per_topk -inf slots lack the sentinel")
        worst = max(worst, float((gs[fin] - ws[fin]).abs().max()),
                    float((gi.long() - wi.long()).abs().max()))
    return worst


def check_priority_scatter(rops, dev):
    """Kernel vs plain version: a batch of draws with repeated indices
    (the last write must win) and out-of-window ones, on the whole pool
    and on a window."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    for rows, lo in ((CAPACITY, 0), (65_536, 131_072)):
        pri = torch.rand(rows, generator=g, device=dev)
        idx = torch.cat([
            torch.randint(lo, lo + rows, (BATCH // 2,), generator=g,
                          device=dev),
            torch.randint(lo, lo + 64, (BATCH // 2 - 8,), generator=g,
                          device=dev),           # many repeats
            torch.tensor([lo - 1, lo + rows, -1, 2**31 - 1, lo + 3,
                          lo + 3, lo + 3, lo + 3], device=dev),
        ]).to(torch.int32)
        vals = torch.rand(BATCH, generator=g, device=dev) * 9
        kw = {"window_start": torch.tensor(lo, dtype=torch.int32,
                                           device=dev)}
        got = rops.priority_scatter(pri.clone(), idx, vals, **kw)
        want = rops.priority_scatter_ref(pri.clone(), idx, vals, **kw)
        require(float(got[3]) == float(vals[-1]), "last write did not win")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def time_per_topk(rops, dev):
    """Times one PER draw's selection: rows 262144 (a full pool), k 8192.
    The library call is the score ops plus ``torch.topk(sorted=True)``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(7)
    pri, gumbel = _per_pool(dev, g, CAPACITY, CAPACITY)

    def library():
        s = torch.where(pri > 0.0,
                        ALPHA * torch.log(torch.clamp(pri, min=1e-12)),
                        float("-inf")) + gumbel
        torch.topk(s, BATCH, sorted=True)

    # both vectors read once, k scores and k indices written once
    moved = 2 * CAPACITY * 4 + BATCH * 8
    return {"ms": event_ms(lambda: rops.per_topk(pri, gumbel, ALPHA, BATCH)),
            "plain_ms": event_ms(
                lambda: rops.per_topk_ref(pri, gumbel, ALPHA, BATCH)),
            "library_ms": event_ms(library),
            "library": "score ops + torch.topk(sorted=True)",
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def time_priority_scatter(rops, dev):
    """Times one update's re-prioritisation: k 8192 distinct drawn rows
    (a full pool has no repeats) into the 262144-row priority vector. The
    library call is ``index_put_``, for timing only (its winner on a
    repeated index is unspecified)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(8)
    pri = torch.rand(CAPACITY, generator=g, device=dev)
    idx = torch.randperm(CAPACITY, generator=g, device=dev)[:BATCH].to(
        torch.int32)
    idx_long = idx.long()
    vals = torch.rand(BATCH, generator=g, device=dev)
    distinct = int(torch.unique(idx).numel())
    # indices and values read once, each distinct row written once
    moved = BATCH * 8 + distinct * 4
    return {"ms": event_ms(lambda: rops.priority_scatter(pri, idx, vals)),
            "plain_ms": event_ms(
                lambda: rops.priority_scatter_ref(pri, idx, vals)),
            "library_ms": event_ms(
                lambda: pri.index_put_((idx_long,), vals)),
            "library": "index_put_",
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


class HostDraws:
    """Draws made on the CPU from a seed and then moved to ``device``, so
    two trainers on different devices consume the same numbers."""

    def __init__(self, env, seed, device):
        import torch
        self.env, self.device = env, device
        self.gen = torch.Generator().manual_seed(seed)

    def _to(self, x):
        return x.to(self.device)

    def sampler_step(self, num_envs, act_dim):
        import torch
        eps = torch.randn((num_envs, act_dim), generator=self.gen)
        reset = self.env.reset_draws(num_envs, self.gen)
        return self._to(eps), {k: self._to(v) for k, v in reset.items()}

    def update(self, replay, batch_size, act_dim):
        import torch
        raw = torch.randint(0, 2 ** 31 - 1, (batch_size,),
                            generator=self.gen, dtype=torch.int32)
        eps = self._to(torch.randn((2, batch_size, act_dim),
                                   generator=self.gen))
        return (self._to(raw) % torch.clamp(replay.size, min=1),
                eps[0], eps[1])

    def per_update(self, capacity, batch_size, act_dim):
        import torch
        u = torch.rand((capacity,), generator=self.gen).clamp_(min=1e-12)
        eps = self._to(torch.randn((2, batch_size, act_dim),
                                   generator=self.gen))
        return self._to(-torch.log(-torch.log(u))), eps[0], eps[1]

    def eval_reset(self, n):
        return {k: self._to(v)
                for k, v in self.env.reset_draws(n, self.gen).items()}


def check_device_vs_cpu(dev, prioritized=False):
    """The port's megastep on the card (kernels) against the port on the
    CPU (plain versions) from one start state with the same draws. The
    CPU side is the one the test suite holds against the JAX package.
    Under PER the batch (100) exceeds the 96 rows written before the
    first update, so the first round's updates cycle their draws and
    re-prioritise repeated rows."""
    import numpy as np
    from repro_torch import interop
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.envs import make
    from repro_torch.rl import AlgoHP

    def cfg(device):
        # capacity 100 is not a multiple of the 32 rows a round writes:
        # writes wrap mid-batch, and sampling runs past the alignment
        return SpreezeConfig(num_envs=4, chunk_len=8,
                             batch_size=100 if prioritized else 256,
                             replay_capacity=100, warmup_frames=64,
                             updates_per_round=2, rounds_per_dispatch=2,
                             prioritized=prioritized,
                             hp=AlgoHP(hidden=(64, 64)), seed=5,
                             device=device)

    cpu = SpreezeTrainer(cfg("cpu"), draws=HostDraws(make("pendulum"), 11,
                                                     "cpu"))
    gpu = SpreezeTrainer(cfg("cuda"), draws=HostDraws(make("pendulum"), 11,
                                                      dev))
    gpu.state = interop.algo_state_from_numpy(
        interop.algo_state_to_numpy(cpu.state), dev)
    gpu.env_states = interop.to_tensors(interop.to_numpy(cpu.env_states),
                                        dev)
    for tr in (cpu, gpu):
        tr._warmup()
        for _ in range(3):
            tr.megastep()
    # float32 on both devices; cuBLAS and the CPU BLAS sum in different
    # orders, and 12 Adam steps carry that rounding into the parameters
    rtol, atol = 1e-3, 1e-4
    if prioritized:
        want = interop.prioritized_to_numpy(cpu.replay)
        got = interop.prioritized_to_numpy(gpu.replay)
        for k in ("priorities", "max_priority"):
            np.testing.assert_allclose(got[k], want[k], rtol, atol,
                                       err_msg=k)
        want, got = want["base"], got["base"]
    else:
        want = interop.replay_to_numpy(cpu.replay)
        got = interop.replay_to_numpy(gpu.replay)
    require(int(got["ptr"]) == int(want["ptr"]) and
            int(got["size"]) == int(want["size"]), "ring counters differ")
    worst = 0.0
    for k in want["data"]:
        np.testing.assert_allclose(got["data"][k], want["data"][k], rtol,
                                   atol, err_msg=k)
    w_state = interop.algo_state_to_numpy(cpu.state)
    g_state = interop.algo_state_to_numpy(gpu.state)
    for k in ("actor", "q", "q_target", "log_alpha"):
        for a, b in zip(tree_leaves(w_state[k]), tree_leaves(g_state[k])):
            np.testing.assert_allclose(b, a, rtol, atol, err_msg=k)
            worst = max(worst, float(np.abs(a - b).max()))
    for k in ("mean_rew", "critic_loss"):
        np.testing.assert_allclose(
            interop.to_numpy(gpu.last_metrics[k]),
            interop.to_numpy(cpu.last_metrics[k]), rtol, atol, err_msg=k)
    return worst, rtol, atol


def run_main_path(rops, dev, megasteps, prioritized=False):
    """SpreezeTrainer.train at full width; counters reset just before.
    Per warmup chunk or round: one ring write per field, plus one for
    the priorities under PER; per update: one gather per field, plus the
    priority mass, one top-k and one scatter under PER."""
    import math
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP

    cfg = SpreezeConfig(num_envs=16, batch_size=BATCH,
                        replay_capacity=CAPACITY, warmup_frames=2048,
                        chunk_len=32, updates_per_round=4,
                        rounds_per_dispatch=4, eval_every_rounds=16,
                        eval_episodes=4, seed=0, prioritized=prioritized,
                        per_alpha=ALPHA, per_beta=0.4,
                        hp=AlgoHP(hidden=(256, 256)), device="cuda")
    tr = SpreezeTrainer(cfg)
    ring = tr.replay.base if prioritized else tr.replay
    per_round = cfg.num_envs * cfg.chunk_len
    warm_chunks = -(-cfg.warmup_frames // per_round)
    rounds = megasteps * cfg.rounds_per_dispatch
    rops.reset_launch_counts()
    hist = tr.train(max_seconds=600.0,
                    max_frames=warm_chunks * per_round + rounds * per_round)
    launches = dict(rops.LAUNCH_COUNTS)
    per_row = len(ring.data) + (1 if prioritized else 0)
    updates = rounds * cfg.updates_per_round
    expect = {"ring_write": per_row * (warm_chunks + rounds),
              "ring_gather": per_row * updates}
    if prioritized:
        expect.update(per_topk=updates, priority_scatter=updates)
    require(tr.total_updates == rounds * cfg.updates_per_round,
            f"ran {tr.total_updates} updates, wanted "
            f"{rounds * cfg.updates_per_round}")
    require(launches == expect,
            f"kernel launches {launches} != expected {expect}")
    frames = tr.total_frames
    require(int(ring.size) == min(frames, CAPACITY) and
            int(ring.ptr) == frames % CAPACITY, "ring counters wrong")
    if prioritized:
        written = tr.replay.priorities[:int(ring.size)]
        require(bool(torch.isfinite(written).all() & (written > 0).all()),
                "a written row's priority is not finite and > 0")
        require(not tr.replay.priorities[int(ring.size):].any(),
                "an unwritten row has a priority")
        require(float(tr.replay.max_priority) >= 1.0, "max_priority < 1")
    for name in ("actor", "q", "q_target"):
        for leaf in tree_leaves(getattr(tr.state, name)):
            require(bool(torch.isfinite(leaf).all()), f"{name} not finite")
    require(bool(torch.isfinite(tr.state.log_alpha)), "log_alpha")
    for k, v in tr.last_metrics.items():
        require(v.shape == (cfg.rounds_per_dispatch,) and
                bool(torch.isfinite(v).all()), f"metric {k}")
    require(len(hist.eval_returns) == rounds // cfg.eval_every_rounds and
            all(math.isfinite(r) for r in hist.eval_returns),
            f"eval returns {hist.eval_returns}")
    return tr, hist, launches


def time_layers(tr):
    """Host wall time of each layer of one full-width round, with the
    device synchronised around it (so each includes its launch cost)."""
    import torch

    def timed(fn, reps=8):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    chunk = {}

    def sampler():
        tr.env_states, chunk["flat"], _ = tr.sampler_chunk(tr.state.actor,
                                                           tr.env_states)

    out = {"sampler_chunk_ms": timed(sampler)}
    out["ring_write_round_ms"] = timed(
        lambda: tr.transfer.push(tr.replay, chunk["flat"]))
    out["update_round_ms"] = timed(
        lambda: tr.update_round(tr.state, tr.replay))
    out["megastep_ms"] = timed(tr.megastep, reps=4)
    return out


def time_per_update_parts(tr):
    """Host wall time of the four parts of one full-width PER update,
    each with the device synchronised around it: the draws (Gumbel field
    over the pool + action noise), the sample (top-k, cycling, 7
    gathers, importance weights), the weighted SAC step, and the
    re-prioritisation."""
    import torch
    from repro_torch.replay import prioritized as per
    cfg = tr.cfg
    act_dim = tr.env.spec.act_dim

    def timed(fn, reps=8):
        out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) / reps * 1e3

    (gumbel, e1, e2), draws_ms = timed(lambda: tr.draws.per_update(
        cfg.replay_capacity, cfg.batch_size, act_dim))
    (batch, idx, w), sample_ms = timed(lambda: per.sample(
        tr.replay, gumbel, cfg.batch_size, alpha=cfg.per_alpha,
        beta=cfg.per_beta))
    batch["weight"] = w
    (_, metrics), update_ms = timed(lambda: tr._update(tr.state, batch, e1,
                                                       e2))
    _, scatter_ms = timed(lambda: per.update_priorities(
        tr.replay, idx, metrics["td_abs"]))
    return {"per_draws_ms": draws_ms, "per_sample_ms": sample_ms,
            "sac_update_ms": update_ms, "reprioritise_ms": scatter_ms}


def kernel_close(got, want):
    """The model kernels' tolerance against their plain versions: float32,
    max abs error <= 1e-5 (the reduction order differs); bfloat16, within
    one bf16 rounding step of the plain result (2**-7 relative) plus the
    same 1e-5. Returns the max abs error."""
    import torch
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"kernel output {got.dtype} {tuple(got.shape)} != plain "
            f"{want.dtype} {tuple(want.shape)}")
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want.float()).abs()
    bad = diff > 1e-5 + rtol * want.float().abs()
    require(bool(torch.isfinite(got).all()), "kernel output not finite")
    require(not bool(bad.any()),
            f"{int(bad.sum())} elements beyond tolerance, max abs err "
            f"{float(diff.max())}")
    return float(diff.max())


def model_inputs(dev, seed, dtype, *shapes):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in shapes]


def check_model_kernels(dev):
    """Each LM kernel against its plain version at the serving path's
    shapes and around them, bf16 and f32. Returns the max abs error of
    each kernel over its cases."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    worst = {"rmsnorm": 0.0, "flash_attention": 0.0,
             "decode_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        # the prefill's rows (8 prompts x 1024) and a decode step's (8)
        for rows in (SERVE_B * SERVE_PROMPT, SERVE_B):
            x, = model_inputs(dev, rows, dtype, (rows, D_MODEL))
            w, = model_inputs(dev, 1, torch.float32, (D_MODEL,))
            worst["rmsnorm"] = max(worst["rmsnorm"], kernel_close(
                rms.rmsnorm(x, w), rms.rmsnorm_ref(x, w)))
        # (B, Sq, Sk, window): the prefill; q at the end of a longer k; a
        # sliding window; a tail that is not a tile multiple
        for B, Sq, Sk, window in ((SERVE_B, SERVE_PROMPT, SERVE_PROMPT,
                                   None),
                                  (2, 200, SERVE_PROMPT, None),
                                  (2, SERVE_PROMPT, SERVE_PROMPT, 256),
                                  (2, 1000, 1000, None)):
            q, k, v = model_inputs(dev, Sq + Sk, dtype,
                                   (B, Sq, HEADS, HEAD_DIM),
                                   (B, Sk, KV_HEADS, HEAD_DIM),
                                   (B, Sk, KV_HEADS, HEAD_DIM))
            worst["flash_attention"] = max(
                worst["flash_attention"], kernel_close(
                    fa.flash_attention(q, k, v, window=window),
                    fa.attention_ref(q, k, v, window=window)))
        # the serving cache (1088 slots, partly valid), and decode_32k's
        for S, valid in ((SERVE_PROMPT + SERVE_GEN, SERVE_PROMPT + 7),
                         (DECODE_LONG, DECODE_LONG)):
            q, k, v = model_inputs(dev, S, dtype,
                                   (SERVE_B, HEADS, HEAD_DIM),
                                   (SERVE_B, S, KV_HEADS, HEAD_DIM),
                                   (SERVE_B, S, KV_HEADS, HEAD_DIM))
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            worst["decode_attention"] = max(
                worst["decode_attention"], kernel_close(
                    dec.decode_attention(q, k, v, vl),
                    dec.decode_attention_ref(q, k, v, vl)))
    return worst


def time_model_kernels(dev):
    """Kernel, plain version and library call, bf16, at the serving
    path's shapes: the prefill's 8192 x 896 norm and its causal attention
    (B 8, 1024 tokens), and one decode step's attention over decode_32k's
    cache (and over the serving cache, printed beside). Bounds: bytes (each
    input read once, each output written once) over 3.35 TB/s, FLOPs over
    the bf16 tensor peak, the larger of the two."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    bf16 = torch.bfloat16
    out = {}

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = SERVE_B * SERVE_PROMPT
    x, = model_inputs(dev, 11, bf16, (rows, D_MODEL))
    w, = model_inputs(dev, 12, torch.float32, (D_MODEL,))
    w_lib = w.to(bf16)
    b, by = bound(2 * x.numel() * 2 + D_MODEL * 4, 4 * x.numel())
    out["rmsnorm"] = {
        "ms": event_ms(lambda: rms.rmsnorm(x, w)),
        "plain_ms": event_ms(lambda: rms.rmsnorm_ref(x, w)),
        "library_ms": event_ms(lambda: F.rms_norm(x, (D_MODEL,), w_lib,
                                                  1e-6)),
        "library": "F.rms_norm (bf16 weight)", "bound_ms": b,
        "bound_by": by, "shape": [rows, D_MODEL]}

    B, S = SERVE_B, SERVE_PROMPT
    q, k, v = model_inputs(dev, 13, bf16, (B, S, HEADS, HEAD_DIM),
                           (B, S, KV_HEADS, HEAD_DIM),
                           (B, S, KV_HEADS, HEAD_DIM))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    pairs = S * (S + 1) // 2                     # causal (query, key) pairs
    b, by = bound(2 * q.numel() * 2 + 2 * k.numel() * 2,
                  4 * B * HEADS * HEAD_DIM * pairs)
    out["flash_attention"] = {
        "ms": event_ms(lambda: fa.flash_attention(q, k, v), iters=20,
                       warmup=3),
        "plain_ms": event_ms(lambda: fa.attention_ref(q, k, v), iters=20,
                             warmup=3),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20,
            warmup=3),
        "library": "F.scaled_dot_product_attention(enable_gqa)",
        "bound_ms": b, "bound_by": by, "shape": [B, S, HEADS, HEAD_DIM]}

    for S, key in ((DECODE_LONG, "decode_attention"),
                   (SERVE_PROMPT + SERVE_GEN, "decode_attention_serving")):
        q, k, v = model_inputs(dev, 14, bf16, (B, HEADS, HEAD_DIM),
                               (B, S, KV_HEADS, HEAD_DIM),
                               (B, S, KV_HEADS, HEAD_DIM))
        vl = torch.tensor(S, dtype=torch.int32, device=dev)
        q4 = q[:, :, None]
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        b, by = bound(2 * k.numel() * 2 + 2 * q.numel() * 2 + 4,
                      4 * B * HEADS * HEAD_DIM * S)
        out[key] = {
            "ms": event_ms(lambda: dec.decode_attention(q, k, v, vl)),
            "plain_ms": event_ms(lambda: dec.decode_attention_ref(q, k, v,
                                                                  vl)),
            "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                q4, kt, vt, enable_gqa=True)),
            "library": "F.scaled_dot_product_attention(enable_gqa)",
            "bound_ms": b, "bound_by": by,
            "shape": [B, S, KV_HEADS, HEAD_DIM]}
        del k, v, kt, vt
    return out


def scan_inputs(dev, seed, dtype, B, S, H, P, N):
    """x, B_, C_ ~ 0.5 N(0, 1) in ``dtype``; dtA = -0.3 softplus(N(0, 1))
    in float32 (a decay exp(dtA) of ~0.5 to ~0.97 a row, 1st to 99th
    percentile)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device=dev) * 0.5).to(dtype)
    dtA = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev)) * 0.3
    Bm = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.5).to(dtype)
    return x, dtA, Bm, Cm


def scan_close(got, want):
    """ssd_scan's tolerance against its plain version: float32 within
    1e-5 of the largest |want| (sums over N and the chunk, in another
    order than cuBLAS's); bfloat16 within one bf16 rounding step (2**-7
    relative) more. Returns the max abs error."""
    import torch
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"scan output {got.dtype} {tuple(got.shape)} != plain "
            f"{want.dtype} {tuple(want.shape)}")
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want.float()).abs()
    bad = diff > 1e-5 * float(want.float().abs().max()) \
        + rtol * want.float().abs()
    require(bool(torch.isfinite(got).all()), "scan output not finite")
    require(not bool(bad.any()),
            f"{int(bad.sum())} elements beyond tolerance, max abs err "
            f"{float(diff.max())}")
    return float(diff.max())


def check_ssd_scan(dev):
    """The scan kernel against its plain version, y and the final state,
    bf16 and f32: both full-width prefill scans, a ragged single chunk
    (L = S = 100, not a multiple of the 64-row tiles) and a small shape.
    Returns the max abs error."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    worst = 0.0
    shapes = list(SCAN_SHAPES.values()) + [(2, 100, 4, 64, 128, 256),
                                           (1, 64, 2, 16, 8, 16)]
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, P, N, chunk in shapes:
            args = scan_inputs(dev, S * H + N, dtype, B, S, H, P, N)
            got = ssd.ssd_scan(*args, chunk=chunk)
            want = ssd.ssd_scan_ref(*args, chunk=chunk)
            for a, b in zip(got, want):
                worst = max(worst, scan_close(a, b))
            del args, got, want
    return worst


def time_ssd_scan(dev, arch):
    """Kernel and plain version, bf16, at ``arch``'s prefill scan. Bound:
    each operand read once (x, B_, C_ as the reference hands them, B and C
    broadcast to every head; dtA float32), y and the final state written
    once, over 3.35 TB/s; the reference's full L x L products (C B^T,
    masked scores times x, C state^T and x^T B per chunk and head) over
    the bf16 tensor peak; the larger of the two."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N, L = SCAN_SHAPES[arch]
    args = scan_inputs(dev, 15, torch.bfloat16, B, S, H, P, N)
    nbytes = 2 * (2 * B * S * H * P + 2 * B * S * H * N + B * H * P * N) \
        + 4 * B * S * H
    flops = B * H * (S // L) * 2 * (L * L * N + L * L * P + 2 * L * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"ms": event_ms(lambda: ssd.ssd_scan(*args, chunk=L), iters=20,
                           warmup=3),
            "plain_ms": event_ms(lambda: ssd.ssd_scan_ref(*args, chunk=L),
                                 iters=20, warmup=3),
            "library_ms": None, "library": "none (no PyTorch call)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
            "shape": [B, S, H, P, N, L]}


def to_device(tree, dev):
    from repro_torch._tree import tree_map
    return tree_map(lambda a: a.to(dev), tree)


def check_serving_device_vs_cpu(dev, arch, layers=2, P=40):
    """Reduced ``arch`` (``layers`` layers) at float32 compute, the same
    parameters and ``P``-token prompts on the card (kernels) and on the
    CPU (plain versions): the logits of the prefill and of 8 decode steps
    (both fed the CPU's tokens) agree within 1e-4 of the largest, and
    greedy_generate gives the same tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve import engine
    cfg = get_config(arch).reduced(num_layers=layers)
    G = 8
    shape = InputShape("smoke", seq_len=P, global_batch=4, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(3))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(4))
    toks = {}
    for where in ("cpu", dev):
        toks[str(where)] = engine.greedy_generate(
            rc, to_device(params, where), to_device(batch, where), P, G)
    want_toks = toks["cpu"]
    require(torch.equal(toks[str(dev)].cpu(), want_toks),
            "served tokens differ between the card and the CPU")
    logits = {}
    for where in ("cpu", dev):
        p = to_device(params, where)
        cache, lg = engine.make_prefill_step(rc, P + G)(
            p, to_device(batch, where))
        cache = engine._grow_cache(cfg, cache, P + G)
        step = engine.make_decode_step(rc)
        out = [lg]
        for i in range(G):
            lg, cache = step(p, want_toks[:, i:i + 1].to(where), cache,
                             torch.tensor(P + i, dtype=torch.int32,
                                          device=where))
            out.append(lg)
        logits[str(where)] = torch.stack(out).cpu()
    want = logits["cpu"]
    rel = float((logits[str(dev)] - want).abs().max() / want.abs().max())
    require(rel <= 1e-4, f"serving logits card vs cpu: {rel} > 1e-4")
    return rel


def run_serving_main_path(dev, arch):
    """Full-width ``arch`` through greedy_generate: counters reset just
    before, exact counts (``SERVE_LAUNCHES``) asserted just after. Then
    the prefill and the decode step are timed through the engine's own
    step functions."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.models import factory
    from repro_torch.serve import engine
    cfg = get_config(arch)
    shape = InputShape("serve", seq_len=SERVE_PROMPT,
                       global_batch=SERVE_B, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape)       # bf16 compute
    params = factory.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, shape,
                       torch.Generator(device=dev).manual_seed(1))
    n_params = sum(a.numel() for a in tree_leaves(params))
    require(n_params == factory.count_params_analytic(cfg),
            f"{n_params} parameters")
    # warm-up (cuBLAS handles, the kernels' first launch), then the run
    engine.greedy_generate(rc, params, batch, SERVE_PROMPT, 2).cpu()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks = engine.greedy_generate(rc, params, batch, SERVE_PROMPT,
                                  SERVE_GEN).cpu()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    expect = SERVE_LAUNCHES[arch]
    require(launches == expect,
            f"kernel launches {launches} != expected {expect}")
    require(toks.shape == (SERVE_B, SERVE_GEN) and
            toks.dtype == torch.int32 and
            bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"tokens {toks.dtype} {tuple(toks.shape)}")

    # layer times: prefill, and decode steps on the prefill's cache
    p = factory.cast_params(params, torch.bfloat16)
    total = SERVE_PROMPT + SERVE_GEN
    prefill = engine.make_prefill_step(rc, total)
    step = engine.make_decode_step(rc)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) / reps * 1e3

    (cache, logits), prefill_ms = timed(lambda: prefill(p, batch), 4)
    require(logits.shape == (SERVE_B, 1, cfg.vocab_size) and
            bool(torch.isfinite(logits).all()), "prefill logits")
    cache = engine._grow_cache(cfg, cache, total)
    tok = toks[:, :1].to(dev)
    pos = torch.tensor(SERVE_PROMPT, dtype=torch.int32, device=dev)
    (logits, _), step_ms = timed(lambda: step(p, tok, cache, pos), 16)
    require(bool(torch.isfinite(logits).all()), "decode logits")
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in tree_leaves(cache))
    stats = {"arch": arch, "batch": SERVE_B, "prompt": SERVE_PROMPT,
             "gen": SERVE_GEN, "params": n_params,
             "wall_s": wall, "tokens_per_s": SERVE_B * SERVE_GEN / wall,
             "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "cache_mb": cache_bytes / 1e6,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    return stats, launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_ops as rops

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    t = time.perf_counter()
    _build.load_kernels()
    print(f"kernels built in {time.perf_counter() - t:.1f} s "
          f"({_build.BUILD_DIR})", flush=True)

    errs = {"ring_write": check_ring_write(rops, dev),
            "ring_gather": check_ring_gather(rops, dev),
            "per_topk": check_per_topk(rops, dev),
            "priority_scatter": check_priority_scatter(rops, dev)}
    for name, err in errs.items():
        require(err == 0.0, f"{name} differs from its plain version: {err}")
    timing = {"ring_write": time_ring_write(rops, dev),
              "ring_gather": time_ring_gather(rops, dev),
              "per_topk": time_per_topk(rops, dev),
              "priority_scatter": time_priority_scatter(rops, dev)}
    for name in errs:
        print(f"{name}: max_abs_err {errs[name]} " + " ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in timing[name].items()), flush=True)

    for prioritized, label in ((False, "uniform"), (True, "PER")):
        worst, rtol, atol = check_device_vs_cpu(dev, prioritized)
        print(f"port on cuda vs port on cpu ({label}, 3 megasteps, small):"
              f" params max abs diff {worst:.3g} within rtol {rtol} atol "
              f"{atol}", flush=True)

    # each main path with its own counts: zeroed just before, read after
    launches = {}
    for prioritized, megasteps in ((False, 12), (True, 24)):
        label = "PER" if prioritized else "uniform"
        tr, hist, counts = run_main_path(rops, dev, megasteps, prioritized)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        rates = {"replay": label, "megasteps": megasteps,
                 "sampling_hz": hist.sampling_hz,
                 "update_hz": hist.update_hz,
                 "update_frame_hz": hist.update_frame_hz,
                 "wall_s": hist.wall_s, "eval_returns": hist.eval_returns,
                 "eval_blocked_s": hist.eval_blocked_s,
                 "launches": counts, "card": card}
        print(f"main path ({label}): " + json.dumps(rates), flush=True)
        layers = time_layers(tr)
        if prioritized:
            layers.update(time_per_update_parts(tr))
        print(f"layers ({label}): " + json.dumps({**layers, "card": card}),
              flush=True)
        del tr
        torch.cuda.empty_cache()

    # the LM model kernels, then the serving path
    model_errs = check_model_kernels(dev)
    model_timing = time_model_kernels(dev)
    for name, t in model_timing.items():
        err = model_errs.get(name, model_errs["decode_attention"])
        print(f"{name}: max_abs_err {err} " + " ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()), flush=True)
    errs.update(model_errs)
    timing.update(model_timing)
    errs["ssd_scan"] = check_ssd_scan(dev)
    for arch in SSM_ARCHS:
        t = time_ssd_scan(dev, arch)
        print(f"ssd_scan ({arch}): max_abs_err {errs['ssd_scan']} " +
              " ".join(f"{k} {v:.5f}" if isinstance(v, float) else
                       f"{k} {v}" for k, v in t.items()), flush=True)
        timing.setdefault("ssd_scan", t)     # the kernels line: mamba2's
    for arch, layers, P in ((SERVE_ARCH, 2, 40), ("mamba2-130m", 2, 64),
                            ("zamba2-1.2b", 5, 64)):
        rel = check_serving_device_vs_cpu(dev, arch, layers, P)
        print(f"serving on cuda vs cpu (reduced {arch}, {layers} layers, "
              f"f32, {P}-token prompts, prefill + 8 decode steps): tokens "
              f"equal, logits max diff {rel:.3g} of the largest (limit "
              f"1e-4)", flush=True)
    for arch in (SERVE_ARCH,) + SSM_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats, counts = run_serving_main_path(dev, arch)
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        print(f"serving main path ({arch}): " +
              json.dumps({**stats, "card": card}), flush=True)
        for k in ("tokens_per_s", "prefill_ms", "decode_step_ms",
                  "peak_mem_gb"):
            print(f"serving {arch} {k} {stats[k]} ({card})", flush=True)

    sources = {"ring_write": ("ring_ops.cu", "replay_ops.py:188"),
               "ring_gather": ("ring_ops.cu", "replay_ops.py:302"),
               "per_topk": ("per_ops.cu", "replay_ops.py:496"),
               "priority_scatter": ("per_ops.cu", "replay_ops.py:553"),
               "rmsnorm": ("rmsnorm.cu", "rmsnorm.py:29"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention.py:77"),
               "decode_attention": ("decode_attention.cu",
                                    "decode_attention.py:63"),
               "ssd_scan": ("ssd_scan.cu", "ssd_scan.py:76")}
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + src,
                "replaces": "src/repro/kernels/" + tpu,
                "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name].get("bound_by", "bytes"),
                "library_ms": timing[name]["library_ms"]}
               for name, (src, tpu) in sources.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
