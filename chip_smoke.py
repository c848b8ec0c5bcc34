#!/usr/bin/env python3
"""Runs the PyTorch port (``src/repro_torch``) on one CUDA card and
checks it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):
  1. the card's name and power limit, and the float32 matmul settings;
  2. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` (timed);
  3. hold each replay kernel against its plain PyTorch version on the
     card at the training path's shapes (max abs error must be 0: the ring
     ops, the row-at-a-time baselines and the scatter copy, the score pass
     and the top-k compute the plain version's bits), then time kernel,
     plain version and the library call with CUDA events (and count
     per_topk's device launches a call under the profiler); then run the
     replay-kernel bench (``repro_torch.benchmarks.replay_kernels``, the
     path of ``per_scores`` and the two row-at-a-time kernels) at its
     tiny and full presets, counters reset just before each and read
     just after, every oracle check holding;
  4. port on the card against port on the CPU, same start state and same
     draws, small sizes, SAC, TD3 and DDPG, each with uniform and with
     prioritized replay, then SAC on CartPole, Reacher and Hopper, and
     SAC through the eager loop, ``sync_mode`` and the queue transfer:
     every replay row, priority, counter, env state and parameter agrees;
  5. drive ``SpreezeTrainer.train`` at the reference's full widths
     (hidden 256x256, batch 8192, capacity 262144, 16 envs x 32 steps,
     4 updates a round, 4 rounds a megastep): SAC with uniform replay and
     with prioritized replay (alpha 0.6, beta 0.4), TD3 with uniform
     replay and DDPG with prioritized replay, with the launch counters
     reset just before each run and read just after: each kernel must
     have been launched exactly as often as the path implies;
  6. time the layers of one round at full width (sampler chunk, ring
     write, update round) and a megastep with CUDA synchronisation around
     each, for each of those paths, and the parts of one PER update; then
     run the training launcher once (``rl --algo td3 --seconds 2``);
  6b. drive, each with exact launch counts: SAC uniform on CartPole,
     Reacher and Hopper (4 megasteps each); the eager loop's
     ``queue-sync`` (Table 1's arm: host queue of 5000, ``sync_mode``;
     1 + rounds // 5 ring writes), ``queue-qs20000`` (Table 2's row:
     1 + rounds // 40 writes) and ``spreeze-nofuse``; the async runtime
     (eval every 4 rounds through the SSD channel, viz every 8 into a
     temporary directory), its eval returns held against an inline
     run's, round by round; then print, not assert, the rates of
     ``spreeze``, ``spreeze-nofuse``, ``queue-qs20000`` and
     ``queue-sync`` and the eval time inline against async, in turns,
     and run ``rl --transfer queue --queue-size 5000 --sync --seconds 2``;
  6c. the resilience paths at full width, each with exact launch counts:
     SAC uniform (6 megasteps) and PER (4) run without a stop, then
     preempted (``FaultPlan(preempt_round=12 / 8)``) and resumed from the
     snapshot, bitwise equal to the uninterrupted run in every leaf of
     the state, the ring and the env states, the draw state, the
     counters and the inline eval history (under PER a draw from one
     Gumbel field then picks the same rows); the async runtime with a
     state snapshot every 4 rounds and injected SSD and eval failures
     (bundles written, workers restarted, the latest bundle restored;
     the publish, write and restore timed); a NaN at round 8 rolled back
     once with the learning rate halved; a probe that a host read raises
     inside ``_sanitize_scope()`` and not after it, then ``sanitize=True``
     on the fused, eager and queue paths, and ``update_hz`` with and
     without it in turns; ``auto_tune`` at the reference's grids (each
     candidate's throughput on a line of its own) and ``rl --adapt
     --seconds 2``;
  7. hold the LM model kernels (rmsnorm, flash_attention,
     decode_attention) against their plain versions on the card at the
     serving path's shapes, in float32 (max abs error <= 1e-5: the
     reduction order differs) and bfloat16 (within one bf16 rounding step
     of the plain result: 2**-7 relative, plus the float32 1e-5), then time
     kernel, plain version and the library call (``F.rms_norm``,
     ``F.scaled_dot_product_attention``), timing only, and flash's float32
     SIMT kernel beside its bf16 tensor-core one; the same for
     ``ssd_scan`` at full-width mamba2-130m's and zamba2-1.2b's prefill
     shapes, mamba2's width over 8 chunks, a ragged single chunk and a
     small shape (float32 within 1e-5 of the largest |plain|, since the
     scan's sums run over N and the chunk; bfloat16 one rounding step
     more), timed with no library call (no PyTorch call computes the
     scan), its float32 SIMT kernels beside its bf16 tensor-core ones;
  8. serve on the card against serving on the CPU, same parameters and
     prompts, prefill plus 8 decode steps: at float32 compute reduced
     qwen2-0.5b, reduced mamba2-130m and reduced zamba2-1.2b (5 layers),
     the logits within 1e-4 of the largest and the tokens identical; at
     bf16 compute (the tensor-core flash kernel) reduced qwen2-0.5b and
     reduced zamba2-1.2b, the logits within the bf16 limits that
     ``tests/test_torch_serve.py`` holds the port to against JAX (2e-2 of
     the largest, zamba2 3e-2);
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
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12           # dense tensor-core bf16, same sheet
F32_FLOP_PER_S = 67e12             # float32 outside the tensor cores
FIELD_WIDTHS = {"obs": 3, "act": 1, "rew": 1, "next_obs": 3, "done": 1,
                "disc": 1}          # the six replay fields, Pendulum
CAPACITY, ROUND_ROWS, BATCH = 262_144, 16 * 32, 8192
ALPHA = 0.6                          # SpreezeConfig.per_alpha
# the serving path: qwen2-0.5b, 8 prompts of 1024 tokens, 64 new tokens
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "qwen2-0.5b", 8, 1024, 64
HEADS, KV_HEADS, HEAD_DIM, D_MODEL = 14, 2, 64, 896
ZAMBA_HEADS = 32                     # zamba2-1.2b's shared attention: 32 / 32
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


def device_launches(fn, calls=20):
    """Device ops (kernels, copies, fills) a call of ``fn`` enqueues,
    counted under torch.profiler after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA
               for e in prof.events()) / calls


def check_ring_write(rops, dev):
    """Kernel vs plain version, every field width, mid-ring, wrapping and
    windowed writes: each width alone, then the trainer's round in one
    launch (the six fields; under PER seven, the priorities' (capacity,
    1) view added), 1-d pools for the width-1 fields as the trainer
    keeps them. Returns the max abs error over all cases."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    g_fields = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    cases = [(CAPACITY, 100_000, None), (CAPACITY, CAPACITY - 200, None),
             # a 65536-row window of the ring that the write straddles
             (65_536, 131_072 - 300, 131_072)]
    pendulum = [() if w == 1 else (w,) for w in FIELD_WIDTHS.values()]
    for rows_local, ptr, lo in cases:
        p = torch.tensor(ptr, dtype=torch.int32, device=dev)
        kw = ({} if lo is None else
              {"capacity": CAPACITY,
               "window_start": torch.tensor(lo, dtype=torch.int32,
                                            device=dev)})
        for width in sorted(set(FIELD_WIDTHS.values())):
            data = torch.randn((rows_local, width), generator=g, device=dev)
            batch = torch.randn((ROUND_ROWS, width), generator=g, device=dev)
            got = rops.ring_write(data.clone(), batch, p, **kw)
            want = rops.ring_write_ref(data.clone(), batch, p, **kw)
            require(not torch.equal(got, data), "ring_write wrote nothing")
            worst = max(worst, float((got - want).abs().max()))
        for shapes in (pendulum, pendulum + [(1,)]):
            datas = [torch.randn((rows_local,) + s, generator=g_fields,
                                 device=dev) for s in shapes]
            batches = [torch.randn((ROUND_ROWS,) + s, generator=g_fields,
                                   device=dev) for s in shapes]
            got = rops.ring_write_fields([d.clone() for d in datas],
                                         batches, p, **kw)
            want = rops.ring_write_fields_ref([d.clone() for d in datas],
                                              batches, p, **kw)
            for gd, wd, d in zip(got, want, datas):
                require(not torch.equal(gd, d),
                        f"ring_write of {len(datas)} fields missed one")
                worst = max(worst, float((gd - wd).abs().max()))
    return worst


def check_ring_gather(rops, dev):
    """Kernel vs plain version, mid-pool, out-of-window, -1 padding and
    windowed indices: each width alone, then the trainer's update in one
    launch (the six fields; under PER seven, the priority mass added),
    1-d pools for the width-1 fields as the trainer keeps them. Returns
    the max abs error over all cases."""
    import torch
    g = torch.Generator(device=dev).manual_seed(2)
    g_fields = torch.Generator(device=dev).manual_seed(14)
    pendulum = [() if w == 1 else (w,) for w in FIELD_WIDTHS.values()]
    worst = 0.0

    def indices(gen, base, rows_local):
        inside = torch.randint(base, base + rows_local, (BATCH - 64,),
                               generator=gen, device=dev)
        outside = torch.cat([
            torch.full((16,), -1, device=dev),
            torch.randint(0, base + 1, (16,), generator=gen,
                          device=dev) - 1,
            torch.randint(base + rows_local, base + 2 * rows_local,
                          (32,), generator=gen, device=dev)])
        return torch.cat([inside, outside]).to(torch.int32)

    for rows_local, lo in ((CAPACITY, None), (65_536, 131_072)):
        base = 0 if lo is None else lo
        kw = {} if lo is None else {
            "window_start": torch.tensor(lo, dtype=torch.int32,
                                         device=dev)}
        for width in sorted(set(FIELD_WIDTHS.values())):
            data = torch.randn((rows_local, width), generator=g, device=dev)
            idx = indices(g, base, rows_local)
            got = rops.ring_gather(data, idx, **kw)
            want = rops.ring_gather_ref(data, idx, **kw)
            require(not got[-64:].any(), "out-of-window rows not zero")
            worst = max(worst, float((got - want).abs().max()))
        for shapes in (pendulum, pendulum + [()]):
            datas = [torch.randn((rows_local,) + s, generator=g_fields,
                                 device=dev) for s in shapes]
            idx = indices(g_fields, base, rows_local)
            got = rops.ring_gather_fields(datas, idx, **kw)
            want = rops.ring_gather_fields_ref(datas, idx, **kw)
            for gd, wd, d in zip(got, want, datas):
                require(gd.shape == (BATCH,) + d.shape[1:] and
                        gd[:-64].any() and not gd[-64:].any(),
                        f"ring_gather of {len(datas)} fields missed one")
                worst = max(worst, float((gd - wd).abs().max()))
    return worst


def time_ring_write(rops, dev, rowloop=False):
    """Times one round's ring write: the six fields, n = 512 rows each,
    with one ``ring_write_fields`` launch, or (``rowloop``) the
    row-at-a-time baseline once a field; the plain version is
    ``ring_write_ref`` for both, the library call ``index_copy_``, once a
    field."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    data = {k: torch.randn((CAPACITY, w), generator=g, device=dev)
            for k, w in FIELD_WIDTHS.items()}
    batch = {k: torch.randn((ROUND_ROWS, w), generator=g, device=dev)
             for k, w in FIELD_WIDTHS.items()}
    datas, batches = list(data.values()), list(batch.values())
    ptr = torch.tensor(100_000, dtype=torch.int32, device=dev)
    dest = (100_000 + torch.arange(ROUND_ROWS, device=dev)) % CAPACITY

    def kernel():
        if not rowloop:
            rops.ring_write_fields(datas, batches, ptr)
            return
        for k in data:
            rops.ring_write_rowloop(data[k], batch[k], ptr)

    def plain():
        for k in data:
            rops.ring_write_ref(data[k], batch[k], ptr)

    def library():
        for k in data:
            data[k].index_copy_(0, dest, batch[k])

    floats = sum(FIELD_WIDTHS.values()) * ROUND_ROWS
    # batch read once + rows written once + ptr read once
    moved = 2 * floats * 4 + 4
    return {"ms": event_ms(kernel), "plain_ms": event_ms(plain),
            "library_ms": event_ms(library),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def time_ring_gather(rops, dev, rowloop=False):
    """Times one update's gather: the six fields, B = 8192 uniform rows,
    with one ``ring_gather_fields`` launch, or (``rowloop``) the
    row-at-a-time baseline once a field; the plain version is
    ``ring_gather_ref`` (or ``ring_gather_rowloop_ref``) once a field,
    the library call ``index_select``, once a field."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    datas = [torch.randn((CAPACITY, w), generator=g, device=dev)
             for w in FIELD_WIDTHS.values()]
    idx = torch.randint(0, CAPACITY, (BATCH,), generator=g, device=dev,
                        dtype=torch.int32)
    idx_long = idx.long()
    plain_fn = rops.ring_gather_rowloop_ref if rowloop else \
        rops.ring_gather_ref

    def kernel():
        if not rowloop:
            rops.ring_gather_fields(datas, idx)
            return
        for v in datas:
            rops.ring_gather_rowloop(v, idx)

    def plain():
        for v in datas:
            plain_fn(v, idx)

    def library():
        for v in datas:
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
    rows in ``ties`` (every row for ``"all"``) share one priority and one
    Gumbel value among the best scores."""
    import torch
    pri = torch.zeros(rows, device=dev)
    pri[:live] = torch.rand(live, generator=g, device=dev) * 5 + 1e-3
    u = torch.rand(rows, generator=g, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    if ties:
        t = (torch.arange(rows, device=dev) if ties == "all"
             else torch.tensor(ties, device=dev))
        pri[t], gumbel[t] = 4.0, 30.0
    return pri, gumbel


def check_per_topk(rops, dev):
    """Kernel vs plain version at the training path's shapes (rows
    262144, k 8192): a full pool, fewer live rows than k, crafted ties,
    every row at one score, 16384 tied rows across the k-th key, and a
    window. Returns the max abs error over the finite scores and all
    indices."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    ties = (7, 4095, 4096, 100_000, CAPACITY - 1)
    for rows, live, lo, tie in ((CAPACITY, CAPACITY, None, ()),
                                (CAPACITY, 5000, None, ()),
                                (CAPACITY, CAPACITY, None, ties),
                                (CAPACITY, CAPACITY, None, "all"),
                                (CAPACITY, CAPACITY, None,
                                 tuple(range(3, CAPACITY, 16))),
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
            tied = list(range(rows) if tie == "all" else tie)[:BATCH]
            require(gi[:len(tied)].tolist() == tied,
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
    """Times one PER draw's selection: rows 262144 (a full pool), k 8192,
    and counts its device launches a call under the profiler. The library
    call is the score ops plus ``torch.topk(sorted=True)``."""
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
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "device_launches": device_launches(
                lambda: rops.per_topk(pri, gumbel, ALPHA, BATCH))}


def scatter_inputs(dev):
    """One update's re-prioritisation: k 8192 distinct drawn rows (a full
    pool has no repeats) of the 262144-row priority vector, and their new
    values."""
    import torch
    g = torch.Generator(device=dev).manual_seed(8)
    pri = torch.rand(CAPACITY, generator=g, device=dev)
    idx = torch.randperm(CAPACITY, generator=g, device=dev)[:BATCH].to(
        torch.int32)
    return pri, idx, torch.rand(BATCH, generator=g, device=dev)


def time_priority_scatter(rops, dev):
    """Times ``scatter_inputs``'s scatter. The library call is
    ``index_put_``, for timing only (its winner on a repeated index is
    unspecified)."""
    import torch
    pri, idx, vals = scatter_inputs(dev)
    idx_long = idx.long()
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


def check_per_scores(rops, dev):
    """Kernel vs plain version over the pool's 262144 rows, half of them
    zero (the -inf path) and some below the 1e-12 floor: the same -inf
    set, and max abs error over the finite scores."""
    import torch
    g = torch.Generator(device=dev).manual_seed(9)
    pri, gumbel = _per_pool(dev, g, CAPACITY, CAPACITY)
    pri[torch.rand(CAPACITY, generator=g, device=dev) < 0.5] = 0.0
    pri[1::97] = 1e-13
    got = rops.per_scores(pri, gumbel, ALPHA)
    want = rops.per_scores_ref(pri, gumbel, ALPHA)
    fin = torch.isfinite(want)
    require(torch.equal(fin, torch.isfinite(got)) and
            torch.equal(~fin, pri == 0), "per_scores -inf set")
    return float((got[fin] - want[fin]).abs().max())


def check_ring_write_rowloop(rops, dev):
    """The row-at-a-time write against its plain version (``ring_write_ref``,
    no window): each field width, n = 512, a write that wraps mid-batch
    and one inside the ring."""
    import torch
    g = torch.Generator(device=dev).manual_seed(10)
    worst = 0.0
    for ptr in (CAPACITY - 200, 100_000):
        for width in sorted(set(FIELD_WIDTHS.values())):
            data = torch.randn((CAPACITY, width), generator=g, device=dev)
            batch = torch.randn((ROUND_ROWS, width), generator=g, device=dev)
            p = torch.tensor(ptr, dtype=torch.int32, device=dev)
            got = rops.ring_write_rowloop(data.clone(), batch, p)
            want = rops.ring_write_ref(data.clone(), batch, p)
            require(torch.equal(got[ptr % CAPACITY], batch[0]),
                    "ring_write_rowloop missed its first slot")
            worst = max(worst, float((got - want).abs().max()))
    return worst


def check_ring_gather_rowloop(rops, dev):
    """The row-at-a-time gather against its plain version: B = 8192 over
    each field width, with repeats, 0, rows - 1 and indices outside the
    pool (a negative one from the end once, the rest clamped)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for width in sorted(set(FIELD_WIDTHS.values())):
        data = torch.randn((CAPACITY, width), generator=g, device=dev)
        drawn = torch.randint(0, CAPACITY, (BATCH // 2 - 4,), generator=g,
                              device=dev)
        idx = torch.cat([drawn, drawn,                     # repeats
                         torch.tensor([0, CAPACITY - 1, CAPACITY + 2, -3],
                                      device=dev)]).to(torch.int32)
        got = rops.ring_gather_rowloop(data, idx)
        want = rops.ring_gather_rowloop_ref(data, idx)
        require(torch.equal(got[-4:], data[[0, CAPACITY - 1, CAPACITY - 1,
                                            CAPACITY - 3]]),
                "ring_gather_rowloop's index rule")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def time_per_scores(rops, dev):
    """Times the score pass over a full pool (262144 rows). No single
    PyTorch call computes it (the library arm of per_topk chains five)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(12)
    pri, gumbel = _per_pool(dev, g, CAPACITY, CAPACITY)
    # both vectors read once, the scores written once
    moved = 3 * CAPACITY * 4
    return {"ms": event_ms(lambda: rops.per_scores(pri, gumbel, ALPHA)),
            "plain_ms": event_ms(
                lambda: rops.per_scores_ref(pri, gumbel, ALPHA)),
            "library_ms": None, "library": "none (no single PyTorch call)",
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def run_bench(dev, tiny):
    """The port's replay-kernel bench (``repro_torch.benchmarks.
    replay_kernels``), one preset, with the counters reset just before
    and read just after: each arm's kernel runs 1 + WARMUP + iters times
    (its check, the warm-up, the timed calls), ``per_scores`` in two arms
    (its own and ``global_topk``), ``per_topk`` 4 more times (the
    two-phase check). Every oracle check must hold."""
    from repro_torch.benchmarks import replay_kernels as bench
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    reset_launch_counts()
    report, ok = bench.run(tiny=tiny, device=dev)
    launches = dict(LAUNCH_COUNTS)
    require(ok and report["oracle_ok"], f"bench oracle failed: {report}")
    calls = 1 + bench.WARMUP + report["config"]["iters"]
    expect = {"ring_write": calls, "ring_write_rowloop": calls,
              "ring_gather": calls, "ring_gather_rowloop": calls,
              "per_scores": 2 * calls, "per_topk": calls + bench.WINDOWS}
    require(launches == expect,
            f"bench launches {launches} != expected {expect}")
    return report, launches


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

    def _noises(self, noises, batch_size, act_dim):
        import torch
        eps = torch.randn((noises, batch_size, act_dim), generator=self.gen)
        return tuple(self._to(e) for e in eps)

    def update(self, replay, batch_size, act_dim, noises=2):
        import torch
        raw = torch.randint(0, 2 ** 31 - 1, (batch_size,),
                            generator=self.gen, dtype=torch.int32)
        return ((self._to(raw) % torch.clamp(replay.size, min=1),)
                + self._noises(noises, batch_size, act_dim))

    def per_update(self, capacity, batch_size, act_dim, noises=2):
        import torch
        u = torch.rand((capacity,), generator=self.gen).clamp_(min=1e-12)
        return ((self._to(-torch.log(-torch.log(u))),)
                + self._noises(noises, batch_size, act_dim))

    def _round(self, stream, n, round_i):
        import torch
        gen = torch.Generator().manual_seed(stream * 1_000_003 + round_i)
        return {k: self._to(v)
                for k, v in self.env.reset_draws(n, gen).items()}

    def eval_reset(self, n, round_i):
        return self._round(1, n, round_i)

    def viz_reset(self, round_i):
        return self._round(2, 1, round_i)


def check_device_vs_cpu(dev, prioritized=False, algo="sac",
                        env_name="pendulum", **loop):
    """The port's megastep with ``algo`` on ``env_name`` on the card
    (kernels) against the port on the CPU (plain versions) from one start
    state with the same draws. The CPU side is the one the test suite
    holds against the JAX package. Under PER the batch (100) exceeds the
    96 rows written before the first update, so the first round's updates
    cycle their draws and re-prioritise repeated rows. ``loop`` holds
    config fields of the eager loop (``fused=False``, ``sync_mode``, the
    queue transfer): its 6 rounds then run one ``eager_round`` at a
    time."""
    import numpy as np
    from repro_torch import interop
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.envs import make
    from repro_torch.rl import AlgoHP

    def cfg(device):
        # capacity 100 is not a multiple of the 32 rows a round writes:
        # writes wrap mid-batch, and sampling runs past the alignment
        return SpreezeConfig(env_name=env_name, algo=algo, num_envs=4,
                             chunk_len=8,
                             batch_size=100 if prioritized else 256,
                             replay_capacity=100, warmup_frames=64,
                             updates_per_round=2, rounds_per_dispatch=2,
                             prioritized=prioritized,
                             hp=AlgoHP(hidden=(64, 64)), seed=5,
                             device=device, **loop)

    cpu = SpreezeTrainer(cfg("cpu"), draws=HostDraws(make(env_name), 11,
                                                     "cpu"))
    gpu = SpreezeTrainer(cfg("cuda"), draws=HostDraws(make(env_name), 11,
                                                      dev))
    gpu.state = interop.algo_state_from_numpy(
        interop.algo_state_to_numpy(cpu.state), dev)
    gpu.env_states = interop.to_tensors(interop.to_numpy(cpu.env_states),
                                        dev)
    for tr in (cpu, gpu):
        tr._warmup()
        for _ in range(3):
            if tr.use_fused:
                tr.megastep()
            else:
                tr.eager_round()
                tr.eager_round()
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
    for k in cpu.env_states:
        np.testing.assert_allclose(interop.to_numpy(gpu.env_states[k]),
                                   interop.to_numpy(cpu.env_states[k]),
                                   rtol, atol, err_msg=k)
    if cpu.use_fused:
        for k in ("mean_rew", "critic_loss"):
            np.testing.assert_allclose(
                interop.to_numpy(gpu.last_metrics[k]),
                interop.to_numpy(cpu.last_metrics[k]), rtol, atol,
                err_msg=k)
    if cpu.cfg.transfer == "queue":
        require(gpu.transfer.q.frames_dropped ==
                cpu.transfer.q.frames_dropped and
                len(gpu.transfer.q.cycle_times) ==
                len(cpu.transfer.q.cycle_times), "queue counters differ")
    return worst, rtol, atol


def run_main_path(rops, dev, megasteps, prioritized=False, algo="sac",
                  env_name="pendulum"):
    """SpreezeTrainer.train with ``algo`` on ``env_name`` at full width,
    eval inline; counters reset just before.
    Per warmup chunk or round: one ring-write launch for every field (the
    priorities too under PER); per update: one gather launch for every
    field (the priority mass too under PER), and one top-k and one
    scatter under PER."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP

    cfg = SpreezeConfig(env_name=env_name, algo=algo, num_envs=16,
                        batch_size=BATCH,
                        replay_capacity=CAPACITY, warmup_frames=2048,
                        chunk_len=32, updates_per_round=4,
                        rounds_per_dispatch=4, eval_every_rounds=16,
                        eval_episodes=4, async_eval=False, seed=0,
                        prioritized=prioritized,
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
    updates = rounds * cfg.updates_per_round
    expect = {"ring_write": warm_chunks + rounds, "ring_gather": updates}
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
    for k in ("mean_rew", "critic_loss"):
        v = tr.last_metrics[k]
        require(v.shape == (cfg.rounds_per_dispatch,) and
                bool(torch.isfinite(v).all()), f"metric {k}")
    require(bool(tr.last_metrics["carry_finite"]), "carry_finite is False")
    # an eval in every megastep whose rounds hold a multiple of 16
    require(len(hist.eval_returns) == -(-rounds // cfg.eval_every_rounds) and
            all(math.isfinite(r) for r in hist.eval_returns),
            f"eval returns {hist.eval_returns}")
    return tr, hist, launches


def full_config(**kw):
    """The reference's default SpreezeConfig at full width (Pendulum, SAC,
    hidden 256x256, 16 envs x 32 steps, batch 8192, capacity 262144, K 4,
    R 4) on the card, with ``kw`` over it."""
    from repro_torch.core import SpreezeConfig
    from repro_torch.rl import AlgoHP
    base = dict(num_envs=16, batch_size=BATCH, replay_capacity=CAPACITY,
                warmup_frames=2048, chunk_len=32, updates_per_round=4,
                rounds_per_dispatch=4, eval_episodes=4, seed=0,
                hp=AlgoHP(hidden=(256, 256)), device="cuda")
    return SpreezeConfig(**{**base, **kw})


# Table 2's settings (benchmarks/table2_throughput.py:run_config): chunk
# 16, warmup 1024, no eval after round 0
TABLE2 = dict(chunk_len=16, warmup_frames=1024, eval_every_rounds=10**9)
# the four transfer arms of Fig. 4a and Table 2, timed in turns
TRANSFER_ARMS = {
    "spreeze": dict(TABLE2),
    "spreeze-nofuse": dict(TABLE2, fused=False),
    "queue-qs20000": dict(TABLE2, transfer="queue", queue_size=20000),
    "queue-sync": dict(TABLE2, transfer="queue", queue_size=5000,
                       sync_mode=True),
}


def run_eager_path(rops, label, rounds, writes, **kw):
    """One eager-loop main path at full width (``full_config(**kw)``),
    ``rounds`` rounds after the warmup, counters reset just before:
    ``writes`` ring writes and one gather launch an update, exactly."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeTrainer
    cfg = full_config(**kw)
    tr = SpreezeTrainer(cfg)
    require(not tr.use_fused, f"{label} runs fused")
    per_round = cfg.num_envs * cfg.chunk_len
    warm = -(-cfg.warmup_frames // per_round) * per_round
    rops.reset_launch_counts()
    t = time.perf_counter()
    hist = tr.train(max_seconds=600.0, max_frames=warm + rounds * per_round)
    wall = time.perf_counter() - t
    launches = dict(rops.LAUNCH_COUNTS)
    expect = {"ring_write": writes,
              "ring_gather": rounds * cfg.updates_per_round}
    require(launches == expect,
            f"{label}: kernel launches {launches} != expected {expect}")
    stats = hist.transfer_stats
    if cfg.transfer == "queue":
        q = tr.transfer.q
        require(stats["transmission_loss"] == 0.0 and q.frames_dropped == 0,
                f"{label}: frames dropped {stats}")
        # the warmup's forced drain, then a drain a full load of rounds
        load = -(-tr.transfer.drain_min // per_round) * per_round
        stored = warm + (writes - 1) * load
        require(int(tr.replay.size) == min(stored, CAPACITY),
                f"{label}: ring holds {int(tr.replay.size)}, wanted "
                f"{stored}")
    else:
        require(int(tr.replay.size) == tr.total_frames, f"{label}: ring")
    for leaf in tree_leaves(tr.state.actor) + tree_leaves(tr.state.q):
        require(bool(torch.isfinite(leaf).all()), f"{label}: not finite")
    require(all(math.isfinite(r) for r in hist.eval_returns) and
            len(hist.eval_returns) >= 1, f"{label}: eval {hist.eval_returns}")
    return hist, launches, wall


def run_async_path(rops, viz_dir):
    """The async host runtime at full width: SAC fused, eval every 4
    rounds through the SSD channel (``weight_sync="ssd"``), viz every 8
    rounds into ``viz_dir``; 8 megasteps, counters reset just before.
    Then the same run with eval inline: each round the async run scored
    has the inline run's return, within 1e-5 relative."""
    from repro_torch.core import SpreezeTrainer
    kw = dict(eval_every_rounds=4, weight_sync="ssd")
    per_round, megasteps = 16 * 32, 8
    frames = 2048 + megasteps * 4 * per_round
    rops.reset_launch_counts()
    t = time.perf_counter()
    tr = SpreezeTrainer(full_config(viz_every_rounds=8, viz_dir=viz_dir,
                                    **kw))
    hist = tr.train(max_seconds=600.0, max_frames=frames)
    wall = time.perf_counter() - t
    launches = dict(rops.LAUNCH_COUNTS)
    expect = {"ring_write": 4 + 4 * megasteps,
              "ring_gather": 4 * 4 * megasteps}
    require(launches == expect,
            f"async: kernel launches {launches} != expected {expect}")
    rt = hist.runtime_stats
    require(rt["published"] == megasteps and rt["eval_done"] >= 1 and
            rt["viz_done"] >= 1 and not rt["degraded"],
            f"async runtime stats {rt}")
    trajs = sorted(f for f in os.listdir(viz_dir) if f.startswith("traj_"))
    import numpy as np
    for f in trajs:
        with np.load(os.path.join(viz_dir, f)) as d:
            require(d["obs"].shape == (200, 3) and
                    np.isfinite(d["rew"]).all(), f"viz file {f}")
    require(len(trajs) == rt["viz_done"], f"viz files {trajs} vs {rt}")
    inline = SpreezeTrainer(full_config(async_eval=False, **kw)).train(
        max_seconds=600.0, max_frames=frames)
    require(inline.eval_rounds == list(range(0, megasteps * 4, 4)),
            f"inline eval rounds {inline.eval_rounds}")
    require(hist.eval_rounds[-1] == inline.eval_rounds[-1] and
            set(hist.eval_rounds) <= set(inline.eval_rounds),
            f"async eval rounds {hist.eval_rounds}")
    worst, bitwise = 0.0, True
    for r, ret in zip(hist.eval_rounds, hist.eval_returns):
        want = inline.eval_returns[inline.eval_rounds.index(r)]
        worst = max(worst, abs(ret - want) / max(abs(want), 1e-30))
        bitwise &= ret == want
    require(worst <= 1e-5, f"async eval returns {hist.eval_returns} vs "
            f"inline {inline.eval_returns}: {worst:.3g} relative")
    return {"wall_s": wall, "eval_rounds": hist.eval_rounds,
            "eval_returns": hist.eval_returns,
            "inline_returns": inline.eval_returns,
            "max_rel_diff": worst, "bit_equal": bitwise,
            "viz_files": len(trajs), "runtime_stats": rt,
            "eval_blocked_s": hist.eval_blocked_s,
            "inline_eval_blocked_s": inline.eval_blocked_s}, launches


def timed_train(max_seconds, **kw):
    """One ``train()`` of ``max_seconds`` after its warmup; its rates."""
    import torch
    from repro_torch.core import SpreezeTrainer
    tr = SpreezeTrainer(full_config(**kw))
    hist = tr.train(max_seconds=max_seconds)
    out = {"sampling_hz": hist.sampling_hz, "update_hz": hist.update_hz,
           "update_frame_hz": hist.update_frame_hz, "wall_s": hist.wall_s,
           "eval_blocked_s": hist.eval_blocked_s,
           "evals": len(hist.eval_returns),
           "transfer_stats": hist.transfer_stats}
    del tr
    torch.cuda.empty_cache()
    return out


def run_queue_launcher():
    """The launcher with the queue ablation, as a user calls it:
    ``rl --transfer queue --queue-size 5000 --sync --seconds 2``."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["rl", "--transfer", "queue", "--queue-size", "5000",
                         "--sync", "--seconds", "2"])
    text = out.getvalue()
    report = json.loads(text[text.index("{"):])
    require(rc == 0 and report["update_hz"] > 0 and
            report["transfer"]["transmission_loss"] == 0.0,
            f"queue launcher report {report}")
    return report


# --------------------------------------------------------------------------- #
# resilience: resume, snapshots, rollback, sanitize, auto-tune
# --------------------------------------------------------------------------- #

def differing_leaves(a, b):
    """The key paths at which two trainer trees are not bitwise equal."""
    import torch
    from repro_torch._tree import leaves_with_path
    ka, kb = list(leaves_with_path(a)), list(leaves_with_path(b))
    require([k for k, _ in ka] == [k for k, _ in kb], "tree keys differ")
    return ["/".join(k) for (k, x), (_, y) in zip(ka, kb)
            if not torch.equal(x, y)]


def path_launches(rounds, warm_chunks=4, updates=4, prioritized=False):
    """One ring write a warmup chunk and a round, one gather an update
    (and one top-k and one scatter an update under PER)."""
    expect = {"ring_write": warm_chunks + rounds,
              "ring_gather": rounds * updates}
    if prioritized:
        expect.update(per_topk=rounds * updates,
                      priority_scatter=rounds * updates)
    return expect


def counted_train(rops, label, tr, expect, **train_kw):
    """``tr.train(**train_kw)`` with the counters zeroed just before and
    read just after; they must equal ``expect``."""
    rops.reset_launch_counts()
    t = time.perf_counter()
    hist = tr.train(max_seconds=600.0, **train_kw)
    wall = time.perf_counter() - t
    launches = dict(rops.LAUNCH_COUNTS)
    require(launches == expect,
            f"{label}: kernel launches {launches} != expected {expect}")
    return hist, launches, wall


def run_resume_path(rops, root, megasteps, preempt_round, prioritized=False):
    """SAC at full width with eval inline every 8 rounds: ``megasteps``
    megasteps without a stop, then the same run preempted at
    ``preempt_round`` (``FaultPlan``) and resumed from its snapshot. The
    resumed trainer equals the uninterrupted one bit for bit: every leaf
    of the state, the ring and the env states, the draw state, the
    counters and the eval history. Under PER a draw from one fixed
    Gumbel field then picks the same rows on both."""
    import torch
    from repro_torch.core import SpreezeTrainer, faults
    from repro_torch.replay import prioritized as per
    kw = dict(eval_every_rounds=8, async_eval=False, prioritized=prioritized,
              per_alpha=ALPHA, per_beta=0.4)
    per_round, rounds = 16 * 32, megasteps * 4
    frames = 2048 + rounds * per_round
    label = "PER" if prioritized else "uniform"
    out, launches = {"megasteps": megasteps, "preempt_round": preempt_round}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    ref = SpreezeTrainer(full_config(**kw))
    hist_ref, counts, out["wall_s"] = counted_train(
        rops, f"resume {label}, uninterrupted", ref,
        path_launches(rounds, prioritized=prioritized), max_frames=frames)
    add(counts)
    snap_dir = os.path.join(root, label)
    pre = SpreezeTrainer(full_config(
        snapshot_dir=snap_dir, snapshot_every_rounds=0,
        fault_plan=faults.FaultPlan(preempt_round=preempt_round), **kw))
    rops.reset_launch_counts()
    t = time.perf_counter()
    preempted = None
    try:
        pre.train(max_seconds=600.0, max_frames=frames)
    except faults.Preempted as e:
        preempted = e
    out["preempted_wall_s"] = time.perf_counter() - t
    counts = dict(rops.LAUNCH_COUNTS)
    expect = path_launches(preempt_round, prioritized=prioritized)
    require(preempted is not None and preempted.round_i == preempt_round,
            f"resume {label}: the run was not preempted at round "
            f"{preempt_round}")
    require(counts == expect, f"resume {label}, preempted: kernel launches "
            f"{counts} != expected {expect}")
    add(counts)
    res = SpreezeTrainer(full_config(snapshot_dir=snap_dir,
                                     snapshot_every_rounds=0, **kw))
    hist_res, counts, out["resumed_wall_s"] = counted_train(
        rops, f"resume {label}, resumed", res,
        path_launches(rounds - preempt_round, warm_chunks=0,
                      prioritized=prioritized),
        max_frames=frames, resume_from=preempted.snapshot_path)
    add(counts)
    diff = differing_leaves((ref.state, ref.replay, ref.env_states),
                            (res.state, res.replay, res.env_states))
    require(not diff, f"resume {label}: leaves not bitwise equal after the "
            f"resume: {diff}")
    require(torch.equal(ref.draws.get_state(), res.draws.get_state()),
            f"resume {label}: draw states differ")
    require((ref.total_frames, ref.total_updates) ==
            (res.total_frames, res.total_updates), f"resume {label}: counters")
    for k in ("eval_rounds", "eval_returns", "env_frames", "update_steps"):
        require(getattr(hist_ref, k) == getattr(hist_res, k),
                f"resume {label}: history {k} {getattr(hist_ref, k)} != "
                f"{getattr(hist_res, k)}")
    require(len(hist_ref.eval_returns) == -(-rounds // 8) and
            all(math.isfinite(r) for r in hist_ref.eval_returns),
            f"resume {label}: eval {hist_ref.eval_returns}")
    if prioritized:
        g = torch.Generator(device="cuda").manual_seed(7)
        u = torch.rand(CAPACITY, generator=g, device="cuda").clamp_(min=1e-12)
        gumbel = -torch.log(-torch.log(u))
        _, idx_ref, w_ref = per.sample(ref.replay, gumbel, BATCH, alpha=ALPHA,
                                       beta=0.4)
        _, idx_res, w_res = per.sample(res.replay, gumbel, BATCH, alpha=ALPHA,
                                       beta=0.4)
        require(torch.equal(idx_ref, idx_res) and torch.equal(w_ref, w_res),
                "resume PER: a draw after the resume picks other rows")
    path = preempted.snapshot_path
    out.update(bitwise_equal=True, eval_rounds=hist_res.eval_rounds,
               bundle_mb=os.path.getsize(path) / 1e6)
    return out, launches


def run_async_snapshots(rops, root):
    """The async runtime at full width with a state snapshot every 4
    rounds (``snapshot_min_interval_s=0``), eval every 4 rounds through
    the SSD channel, one injected SSD write failure (round 0) and one
    transient eval failure (round 4); 6 megasteps. The snapshot worker
    writes at least one bundle, the supervisor restarts a worker, and the
    latest bundle restores into a fresh trainer. Then the publish on the
    train thread, the write and the restore are timed."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeTrainer, faults
    from repro_torch.train import resume
    megasteps = 6
    cfg = full_config(
        snapshot_dir=root, snapshot_every_rounds=4, snapshot_min_interval_s=0,
        eval_every_rounds=4, weight_sync="ssd", worker_heartbeat_s=60,
        fault_plan=faults.FaultPlan(ssd_oserror_rounds=(0,),
                                    eval_error_rounds=(4,)))
    tr = SpreezeTrainer(cfg)
    hist, launches, wall = counted_train(
        rops, "async snapshots", tr, path_launches(megasteps * 4),
        max_frames=2048 + megasteps * 4 * 512)
    rt = hist.runtime_stats
    require(rt["state_done"] >= 1 and rt["worker_restarts"] >= 1 and
            not rt["degraded"] and rt["eval_done"] >= 1,
            f"async snapshots: runtime stats {rt}")
    path = resume.latest(root)
    require(path is not None, "async snapshots: no bundle written")
    fresh = SpreezeTrainer(cfg)
    t = time.perf_counter()
    meta = resume.restore_trainer(fresh, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    require(meta["round_i"] % 4 == 0 and fresh.total_frames > 2048,
            f"async snapshots: restored meta {meta}")
    publish_ms, publish_sync_ms = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        item = resume.publishable(tr, hist, 10**6 + i)
        publish_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        publish_sync_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    resume.write_bundle(os.path.join(root, "timed"), item)
    write_s = time.perf_counter() - t
    bundle_mb = sum(t.numel() * t.element_size()
                    for t in tree_leaves(item.bundle)) / 1e6
    return {"wall_s": wall, "runtime_stats": rt, "restored_round": meta[
        "round_i"], "bundle_mb": bundle_mb,
        "publish_ms_train_thread": sorted(publish_ms)[2],
        "publish_ms_with_sync": sorted(publish_sync_ms)[2],
        "write_s": write_s, "restore_s": restore_s}, launches


def run_rollback_path(rops, root):
    """A NaN written into the actor at round 8 (``FaultPlan``), inline
    snapshots every 4 rounds, 16 rounds of budget: the poisoned bundle of
    round 12 is skipped with a warning, the guard trips, the trainer
    rolls back once to round 8's snapshot with the learning rate halved
    and runs to the budget: megasteps at rounds 0, 4, 8 (poisoned), 8,
    12, so 4 + 20 writes and 80 gathers."""
    import warnings
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeTrainer, faults
    cfg = full_config(snapshot_dir=root, snapshot_every_rounds=4,
                      snapshot_min_interval_s=0, async_eval=False,
                      fault_plan=faults.FaultPlan(nan_round=8))
    tr = SpreezeTrainer(cfg)
    lr0 = tr.hp.lr
    rollback_s = []
    rollback = tr._rollback

    def timed_rollback(*a):
        t = time.perf_counter()
        out = rollback(*a)
        rollback_s.append(time.perf_counter() - t)
        return out

    tr._rollback = timed_rollback
    budget = 2048 + 16 * 512
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hist, launches, wall = counted_train(
            rops, "NaN rollback", tr, path_launches(20), max_frames=budget)
    msgs = [str(x.message) for x in w]
    require(hist.runtime_stats["rollbacks"] == 1 and len(rollback_s) == 1,
            f"NaN rollback: {hist.runtime_stats}")
    require(tr.hp.lr == lr0 * 0.5, f"NaN rollback: lr {tr.hp.lr}")
    require(tr.total_frames == budget, f"NaN rollback: {tr.total_frames}")
    require(all(bool(torch.isfinite(p).all())
                for p in tree_leaves(tr.state.actor)), "NaN rollback: actor")
    require(any("skipping snapshot at round 12" in m for m in msgs) and
            any("rolled back" in m for m in msgs),
            f"NaN rollback: warnings {msgs}")
    return {"wall_s": wall, "rollback_s": rollback_s[0], "lr": tr.hp.lr,
            "rollbacks": 1}, launches


def sanitize_probe(dev):
    """Inside ``_sanitize_scope()`` a host read of a card tensor raises;
    after it, it runs."""
    import torch
    from repro_torch.core import SpreezeTrainer
    tr = SpreezeTrainer(full_config(sanitize=True, replay_capacity=4096,
                                    batch_size=256))
    x = torch.ones((), device=dev)
    raised = False
    with tr._sanitize_scope():
        require(torch.cuda.get_sync_debug_mode() == 2, "debug mode not set")
        try:
            x.item()
        except RuntimeError:
            raised = True
    require(raised, "a .item() inside the sanitize scope did not raise")
    require(torch.cuda.get_sync_debug_mode() == 0 and x.item() == 1.0,
            "the sanitize scope did not restore the debug mode")


def run_sanitized(rops, label, rounds, writes, **kw):
    """A sanitized ``train()`` at full width, ``rounds`` rounds after the
    warmup, counters reset just before: ``writes`` ring writes and a
    gather an update, exactly; no operation raises under "error"."""
    import torch
    from repro_torch.core import SpreezeTrainer
    tr = SpreezeTrainer(full_config(sanitize=True, **kw))
    hist, launches, wall = counted_train(
        rops, f"sanitize {label}", tr,
        {"ring_write": writes, "ring_gather": rounds * 4},
        max_frames=2048 + rounds * 512)
    require(torch.cuda.get_sync_debug_mode() == 0 and hist.update_hz > 0,
            f"sanitize {label}")
    return {"rounds": rounds, "update_hz": hist.update_hz, "wall_s": wall,
            "evals": len(hist.eval_returns)}, launches


def run_auto_tune(rops):
    """``auto_tune("pendulum", "sac")`` at the reference's grids, iters 3,
    counters reset just before. Its update probe gathers once a call
    (1 warm-up + 3 timed calls a batch size probed); its megastep probe
    runs 4 megasteps of r rounds a candidate r: r writes and 4r gathers
    each."""
    from repro_torch.core import auto_tune
    rops.reset_launch_counts()
    t = time.perf_counter()
    tuned = auto_tune("pendulum", "sac", iters=3)
    wall = time.perf_counter() - t
    launches = dict(rops.LAUNCH_COUNTS)
    rs = [c["value"] for c in tuned["rpd_log"].candidates]
    expect = {"ring_gather": 4 * len(tuned["bs_log"].candidates) +
              sum(4 * 4 * r for r in rs), "ring_write": sum(4 * r for r in rs)}
    require(launches == expect,
            f"auto_tune: kernel launches {launches} != expected {expect}")
    return tuned, wall, launches


def run_adapt_launcher():
    """``rl --adapt --seconds 2``, as a user calls it: the ``[adapt]``
    line, then a report with every rate > 0."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["rl", "--adapt", "--seconds", "2"])
    wall = time.perf_counter() - t
    text = out.getvalue()
    adapt = [ln for ln in text.splitlines() if ln.startswith("[adapt]")]
    report = json.loads(text[text.index("{"):])
    require(rc == 0 and len(adapt) == 1 and report["update_hz"] > 0,
            f"adapt launcher: {text[-2000:]}")
    return adapt[0], report, wall


def time_layers(tr):
    """Host wall time of each layer of one full-width round (sampler
    chunk, ring write, update round) and of a megastep, with the device
    synchronised around each (so each includes its launch cost)."""
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
    over the pool + action noise), the sample (top-k, cycling, one
    gather launch of 7 fields, importance weights), the weighted update, and the
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

    (gumbel, *eps), draws_ms = timed(lambda: tr.draws.per_update(
        cfg.replay_capacity, cfg.batch_size, act_dim,
        tr.algo.UPDATE_NOISES))
    (batch, idx, w), sample_ms = timed(lambda: per.sample(
        tr.replay, gumbel, cfg.batch_size, alpha=cfg.per_alpha,
        beta=cfg.per_beta))
    batch["weight"] = w
    (_, metrics), update_ms = timed(lambda: tr._update(tr.state, batch,
                                                       *eps))
    _, scatter_ms = timed(lambda: per.update_priorities(
        tr.replay, idx, metrics["td_abs"]))
    return {"per_draws_ms": draws_ms, "per_sample_ms": sample_ms,
            f"{cfg.algo}_update_ms": update_ms,
            "reprioritise_ms": scatter_ms}


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
        # (B, Sq, Sk, window, q scale): the prefill; q at the end of a
        # longer k; a sliding window; a tail that is not a tile multiple;
        # a long sequence (many rescales of the running sums); q times 8
        # (a peaked softmax: probabilities over many binades)
        for B, Sq, Sk, window, q_scale in (
                (SERVE_B, SERVE_PROMPT, SERVE_PROMPT, None, 1),
                (2, 200, SERVE_PROMPT, None, 1),
                (2, SERVE_PROMPT, SERVE_PROMPT, 256, 1),
                (2, 1000, 1000, None, 1),
                (1, 2 * SERVE_PROMPT, 2 * SERVE_PROMPT, None, 1),
                (2, SERVE_PROMPT, SERVE_PROMPT, None, 8)):
            # seed Sq + Sk for q scale 1, as before the q-scale column
            q, k, v = model_inputs(dev, Sq + Sk + q_scale - 1, dtype,
                                   (B, Sq, HEADS, HEAD_DIM),
                                   (B, Sk, KV_HEADS, HEAD_DIM),
                                   (B, Sk, KV_HEADS, HEAD_DIM))
            q = q * q_scale             # a power of two: exact in bf16
            worst["flash_attention"] = max(
                worst["flash_attention"], kernel_close(
                    fa.flash_attention(q, k, v, window=window),
                    fa.attention_ref(q, k, v, window=window)))
        # (S, valid, heads, kv heads, seed): the serving cache (1088
        # slots, partly valid), decode_32k's, zamba2's serving cache (32
        # heads, 32 kv heads) and a cache with no valid slot (zeros)
        serving = SERVE_PROMPT + SERVE_GEN
        for S, valid, H, KV, seed in (
                (serving, SERVE_PROMPT + 7, HEADS, KV_HEADS, serving),
                (DECODE_LONG, DECODE_LONG, HEADS, KV_HEADS, DECODE_LONG),
                (serving, serving, ZAMBA_HEADS, ZAMBA_HEADS, serving + 1),
                (serving, 0, HEADS, KV_HEADS, serving + 2)):
            q, k, v = model_inputs(dev, seed, dtype,
                                   (SERVE_B, H, HEAD_DIM),
                                   (SERVE_B, S, KV, HEAD_DIM),
                                   (SERVE_B, S, KV, HEAD_DIM))
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
    cache (and over qwen2's and zamba2's serving caches, printed beside).
    Bounds: bytes (each input read once, each output written once) over
    3.35 TB/s, FLOPs over the bf16 tensor peak (decode attention: its
    float32 FLOPs over the float32 peak), the larger of the two."""
    import torch
    import torch.nn.functional as F
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
    q32, k32, v32 = (a.float() for a in (q, k, v))
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
        "bound_ms": b, "bound_by": by, "shape": [B, S, HEADS, HEAD_DIM],
        # the float32 operands' SIMT kernel, same shape
        "simt_f32_ms": event_ms(lambda: fa.flash_attention(q32, k32, v32),
                                iters=20, warmup=3)}
    del q32, k32, v32

    serving = SERVE_PROMPT + SERVE_GEN
    for S, H, KV, key in (
            (DECODE_LONG, HEADS, KV_HEADS, "decode_attention"),
            (serving, HEADS, KV_HEADS, "decode_attention_serving"),
            (serving, ZAMBA_HEADS, ZAMBA_HEADS, "decode_attention_zamba2")):
        out[key] = time_decode_attention(dev, B, S, H, KV)
    return out


def time_decode_attention(dev, B, S, H, KV, iters=200):
    """One decode step's attention, bf16, every slot of the (B, S, KV, 64)
    cache valid: kernel, plain version and SDPA. Bound: the bytes (K and
    V read once, q read and the output written once) over 3.35 TB/s, or
    the float32 operations (a score and its share of P V, 4 d a head and
    slot) over the CUDA cores' float32 rate, the larger."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    q, k, v = model_inputs(dev, 14, torch.bfloat16, (B, H, HEAD_DIM),
                           (B, S, KV, HEAD_DIM), (B, S, KV, HEAD_DIM))
    vl = torch.tensor(S, dtype=torch.int32, device=dev)
    q4 = q[:, :, None]
    kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
    t_bytes = (2 * k.numel() * 2 + 2 * q.numel() * 2 + 4) / \
        HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * H * HEAD_DIM * S / F32_FLOP_PER_S * 1e3
    return {
        "ms": event_ms(lambda: dec.decode_attention(q, k, v, vl), iters),
        "plain_ms": event_ms(lambda: dec.decode_attention_ref(q, k, v, vl),
                             iters),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, enable_gqa=True), iters),
        "library": "F.scaled_dot_product_attention(enable_gqa)",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": [B, S, H, KV, HEAD_DIM]}


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
    bf16 and f32: both full-width prefill scans, mamba2's width over 8
    chunks (S 2048), a ragged single chunk (L = S = 100, not a multiple of
    the 64-row tiles) and a small shape. Returns the max abs error."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    worst = 0.0
    shapes = list(SCAN_SHAPES.values()) + [(2, 2048, 24, 64, 128, 256),
                                           (2, 100, 4, 64, 128, 256),
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
    """Kernel and plain version, bf16, at ``arch``'s prefill scan, and the
    float32 kernels (SIMT) on the same values upcast. Bound: each operand
    read once (x, B_, C_ as the reference hands them, B and C broadcast to
    every head; dtA float32), y and the final state written once, over
    3.35 TB/s; the reference's full L x L products (C B^T, masked scores
    times x, C state^T and x^T B per chunk and head) over the bf16 tensor
    peak; the larger of the two."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N, L = SCAN_SHAPES[arch]
    args = scan_inputs(dev, 15, torch.bfloat16, B, S, H, P, N)
    f32 = [a.float() for a in args]
    nbytes = 2 * (2 * B * S * H * P + 2 * B * S * H * N + B * H * P * N) \
        + 4 * B * S * H
    flops = B * H * (S // L) * 2 * (L * L * N + L * L * P + 2 * L * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"ms": event_ms(lambda: ssd.ssd_scan(*args, chunk=L), iters=20,
                           warmup=3),
            "plain_ms": event_ms(lambda: ssd.ssd_scan_ref(*args, chunk=L),
                                 iters=20, warmup=3),
            "simt_f32_ms": event_ms(lambda: ssd.ssd_scan(*f32, chunk=L),
                                    iters=20, warmup=3),
            "library_ms": None, "library": "none (no PyTorch call)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": nbytes / 1e6, "gflop": flops / 1e9,
            "shape": [B, S, H, P, N, L]}


def to_device(tree, dev):
    from repro_torch._tree import tree_map
    return tree_map(lambda a: a.to(dev), tree)


# Card against CPU, serving: the logits' limit, relative to the largest,
# by compute dtype: float32 1e-4; bfloat16 those of tests/test_torch_serve.py
# against the reference (2e-2; zamba2 3e-2, where the reference's own two
# paths lie 2.4-4.8e-2 apart)
SERVE_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_LOGIT_TOL_BF16 = {"zamba2-1.2b": 3e-2}


def check_serving_device_vs_cpu(dev, arch, layers=2, P=40,
                                compute_dtype="float32"):
    """Reduced ``arch`` (``layers`` layers) at ``compute_dtype``, the same
    parameters and ``P``-token prompts on the card (kernels) and on the
    CPU (plain versions): the logits of the prefill and of 8 decode steps
    (both fed the CPU's tokens) agree within ``SERVE_LOGIT_TOL`` of the
    largest; at float32 greedy_generate also gives the same tokens (bf16
    logits tie too easily for that). Returns the gap and its limit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve import engine
    cfg = get_config(arch).reduced(num_layers=layers)
    G = 8
    shape = InputShape("smoke", seq_len=P, global_batch=4, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype=compute_dtype)
    tol = SERVE_LOGIT_TOL[compute_dtype]
    if compute_dtype == "bfloat16":
        tol = SERVE_LOGIT_TOL_BF16.get(arch, tol)
    params = factory.init_params(cfg, torch.Generator().manual_seed(3))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(4))
    toks = {}
    for where in ("cpu", dev):
        toks[str(where)] = engine.greedy_generate(
            rc, to_device(params, where), to_device(batch, where), P, G)
    want_toks = toks["cpu"]
    require(compute_dtype != "float32" or
            torch.equal(toks[str(dev)].cpu(), want_toks),
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
    want = logits["cpu"].float()
    rel = float((logits[str(dev)].float() - want).abs().max()
                / want.abs().max())
    require(rel <= tol, f"serving logits card vs cpu ({compute_dtype}): "
            f"{rel} > {tol}")
    return rel, tol


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


def run_launcher():
    """One short run of the training launcher, in this process, as a user
    calls it: ``rl --algo td3 --seconds 2`` (full widths, the card). Its
    JSON report must parse, with every rate > 0."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["rl", "--algo", "td3", "--seconds", "2"])
    text = out.getvalue()
    report = json.loads(text[text.index("{"):])
    require(rc == 0 and all(report[k] > 0 for k in
                            ("sampling_hz", "update_hz", "update_frame_hz")),
            f"launcher report {report}")
    return report


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
            "priority_scatter": check_priority_scatter(rops, dev),
            "per_scores": check_per_scores(rops, dev),
            "ring_write_rowloop": check_ring_write_rowloop(rops, dev),
            "ring_gather_rowloop": check_ring_gather_rowloop(rops, dev)}
    for name, err in errs.items():
        require(err == 0.0, f"{name} differs from its plain version: {err}")
    timing = {"ring_write": time_ring_write(rops, dev),
              "ring_gather": time_ring_gather(rops, dev),
              "per_topk": time_per_topk(rops, dev),
              "priority_scatter": time_priority_scatter(rops, dev),
              "per_scores": time_per_scores(rops, dev),
              "ring_write_rowloop": time_ring_write(rops, dev,
                                                    rowloop=True),
              "ring_gather_rowloop": time_ring_gather(rops, dev,
                                                      rowloop=True)}
    for name in errs:
        print(f"{name}: max_abs_err {errs[name]} " + " ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in timing[name].items()), flush=True)

    # each main path with its own counts: zeroed just before, read after;
    # the kernels line sums them
    launches = {}

    def add_launches(counts):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c

    # the replay-kernel bench: the path of per_scores and the rowloops
    for tiny in (True, False):
        report, counts = run_bench(dev, tiny)
        add_launches(counts)
        print(f"bench ({'tiny' if tiny else 'full'}): " + json.dumps(
            {**report, "launches": counts, "card": card}), flush=True)

    for algo, prioritized in (("sac", False), ("sac", True),
                              ("td3", False), ("td3", True),
                              ("ddpg", False), ("ddpg", True)):
        worst, rtol, atol = check_device_vs_cpu(dev, prioritized, algo)
        print(f"port on cuda vs port on cpu ({algo}, "
              f"{'PER' if prioritized else 'uniform'}, 3 megasteps, small):"
              f" params max abs diff {worst:.3g} within rtol {rtol} atol "
              f"{atol}", flush=True)
    for label, kw in (("cartpole", dict(env_name="cartpole")),
                      ("reacher", dict(env_name="reacher")),
                      ("hopper", dict(env_name="hopper")),
                      ("eager loop", dict(fused=False)),
                      ("sync_mode", dict(sync_mode=True)),
                      ("queue transfer, 80 rows",
                       dict(transfer="queue", queue_size=80))):
        worst, rtol, atol = check_device_vs_cpu(dev, **kw)
        print(f"port on cuda vs port on cpu (sac, uniform, {label}, 6 "
              f"rounds, small): params max abs diff {worst:.3g} within rtol"
              f" {rtol} atol {atol}", flush=True)

    for algo, prioritized, megasteps in (("sac", False, 8),
                                         ("sac", True, 8),
                                         ("td3", False, 6),
                                         ("ddpg", True, 6)):
        label = "PER" if prioritized else "uniform"
        if algo != "sac":
            label = f"{algo.upper()} {label}"
        tr, hist, counts = run_main_path(rops, dev, megasteps, prioritized,
                                         algo)
        add_launches(counts)
        rates = {"algo": algo, "replay": label, "megasteps": megasteps,
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
    print("launcher (rl --algo td3 --seconds 2): " + json.dumps(
        {**run_launcher(), "card": card}), flush=True)

    # the other envs, the eager loop, the queue and the async runtime
    t_new = time.perf_counter()
    for env_name in ("cartpole", "reacher", "hopper"):
        t = time.perf_counter()
        tr, hist, counts = run_main_path(rops, dev, 4, env_name=env_name)
        add_launches(counts)
        print(f"main path (SAC uniform, {env_name}): " + json.dumps(
            {"megasteps": 4, "sampling_hz": hist.sampling_hz,
             "update_hz": hist.update_hz,
             "eval_returns": hist.eval_returns, "launches": counts,
             "wall_s": time.perf_counter() - t, "card": card}), flush=True)
        del tr
        torch.cuda.empty_cache()
    for label, rounds, writes, kw in (
            ("queue-sync", 20, 1 + 20 // 5,
             dict(transfer="queue", queue_size=5000, sync_mode=True,
                  eval_every_rounds=16)),
            ("queue-qs20000", 40, 1 + 40 // 40,
             TRANSFER_ARMS["queue-qs20000"]),
            ("spreeze-nofuse", 16, 4 + 16, TRANSFER_ARMS["spreeze-nofuse"])):
        hist, counts, wall = run_eager_path(rops, label, rounds, writes,
                                            **kw)
        add_launches(counts)
        print(f"main path ({label}, {rounds} rounds): " + json.dumps(
            {"sampling_hz": hist.sampling_hz, "update_hz": hist.update_hz,
             "transfer_stats": hist.transfer_stats,
             "eval_returns": hist.eval_returns, "launches": counts,
             "wall_s": wall, "card": card}), flush=True)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_viz_") as viz_dir:
        stats, counts = run_async_path(rops, viz_dir)
    add_launches(counts)
    print("main path (async runtime, SSD weight sync, viz, 8 megasteps): "
          + json.dumps({**stats, "launches": counts, "card": card}),
          flush=True)
    agree = "bit-equal to" if stats["bit_equal"] else "within 1e-5 of"
    print(f"async eval returns {agree} the inline run's "
          f"({stats['max_rel_diff']:.3g} relative)", flush=True)
    # Fig. 4a's arms and inline against async eval, 1.5 s each, in turns
    for name in list(TRANSFER_ARMS) + list(reversed(TRANSFER_ARMS)):
        print(f"rates ({name}, 1.5 s): " + json.dumps(
            {**timed_train(1.5, **TRANSFER_ARMS[name]), "card": card}),
            flush=True)
    for mode in ("inline", "async", "async", "inline"):
        print(f"eval every 4 rounds ({mode}, 1.5 s): " + json.dumps(
            {**timed_train(1.5, eval_every_rounds=4,
                           async_eval=mode == "async"), "card": card}),
            flush=True)
    print("launcher (rl --transfer queue --queue-size 5000 --sync "
          "--seconds 2): " + json.dumps({**run_queue_launcher(),
                                         "card": card}), flush=True)
    print(f"new paths: {time.perf_counter() - t_new:.1f} s", flush=True)

    # resume, snapshots, rollback, sanitize and auto-tune
    t_res = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as root:
        for megasteps, preempt, prioritized in ((6, 12, False),
                                                (4, 8, True)):
            stats, counts = run_resume_path(rops, root, megasteps, preempt,
                                            prioritized)
            add_launches(counts)
            print(f"resume ({'PER' if prioritized else 'uniform'}, preempted"
                  f" at round {preempt}, resumed): bitwise equal to the "
                  f"uninterrupted run; " + json.dumps(
                      {**stats, "launches": counts, "card": card}),
                  flush=True)
        stats, counts = run_async_snapshots(rops,
                                            os.path.join(root, "async"))
        add_launches(counts)
        print("async snapshots (every 4 rounds, SSD sync, injected SSD and "
              "eval failures): " + json.dumps(
                  {**stats, "launches": counts, "card": card}), flush=True)
        stats, counts = run_rollback_path(rops, os.path.join(root, "nan"))
        add_launches(counts)
        print("NaN rollback (nan_round 8, snapshots every 4 rounds): " +
              json.dumps({**stats, "launches": counts, "card": card}),
              flush=True)
    sanitize_probe(dev)
    print("sanitize probe: .item() raises inside the scope, runs after it",
          flush=True)
    for label, rounds, writes, kw in (
            ("fused", 16, 4 + 16, {}),
            ("eager", 8, 4 + 8, dict(fused=False)),
            ("queue", 10, 1 + 10 // 5, dict(transfer="queue",
                                            queue_size=5000))):
        stats, counts = run_sanitized(rops, label, rounds, writes, **kw)
        add_launches(counts)
        print(f"sanitize ({label}, sync debug mode \"error\"): " + json.dumps(
            {**stats, "launches": counts, "card": card}), flush=True)
    for on in (False, True, True, False):
        print(f"update_hz (sanitize {'on' if on else 'off'}, 1.5 s): " +
              json.dumps({**timed_train(1.5, sanitize=on,
                                        eval_every_rounds=10**9),
                          "card": card}), flush=True)
    tuned, wall, counts = run_auto_tune(rops)
    add_launches(counts)
    for knob in ("bs", "env", "rpd"):
        for c in tuned[f"{knob}_log"].candidates:
            print(f"auto_tune {knob} {c['value']}: throughput "
                  f"{c['throughput']} ({card})", flush=True)
    print("auto_tune (reference grids, iters 3): " + json.dumps(
        {k: tuned[k] for k in ("batch_size", "num_envs",
                               "rounds_per_dispatch")} |
        {"wall_s": wall, "launches": counts, "card": card}), flush=True)
    line, report, wall = run_adapt_launcher()
    print(f"launcher (rl --adapt --seconds 2): {line}; " + json.dumps(
        {**report, "wall_s": wall, "card": card}), flush=True)
    print(f"resilience paths: {time.perf_counter() - t_res:.1f} s",
          flush=True)

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
    for arch, layers, P, dtype in (
            (SERVE_ARCH, 2, 40, "float32"), ("mamba2-130m", 2, 64, "float32"),
            ("zamba2-1.2b", 5, 64, "float32"),
            (SERVE_ARCH, 2, 40, "bfloat16"),
            ("zamba2-1.2b", 5, 64, "bfloat16")):
        rel, tol = check_serving_device_vs_cpu(dev, arch, layers, P, dtype)
        print(f"serving on cuda vs cpu (reduced {arch}, {layers} layers, "
              f"{dtype}, {P}-token prompts, prefill + 8 decode steps): "
              f"{'tokens equal, ' if dtype == 'float32' else ''}logits max "
              f"diff {rel:.3g} of the largest (limit {tol})", flush=True)
    for arch in (SERVE_ARCH,) + SSM_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats, counts = run_serving_main_path(dev, arch)
        add_launches(counts)
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
               "ssd_scan": ("ssd_scan.cu", "ssd_scan.py:76"),
               "per_scores": ("per_ops.cu", "replay_ops.py:369"),
               "ring_write_rowloop": ("ring_ops.cu", "replay_ops.py:609"),
               "ring_gather_rowloop": ("ring_ops.cu", "replay_ops.py:644")}
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + src,
                "replaces": "src/repro/kernels/" + tpu,
                "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name].get("bound_by", "bytes"),
                "library_ms": timing[name]["library_ms"],
                **({"simt_f32_ms": timing[name]["simt_f32_ms"]}
                   if "simt_f32_ms" in timing[name] else {})}
               for name, (src, tpu) in sources.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
