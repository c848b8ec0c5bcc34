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
  6d. the multi-device megastep on the one-card stand-in (meshes that
     name cuda:0 at every position): the sharded wrappers at G 2 and 8
     bitwise against the single-device kernels on the whole pool at the
     training path's shapes; ``train()`` at full width on SAC uniform
     and SAC PER over an ac 2x2 mesh (4 megasteps), TD3 uniform and DDPG
     PER over a dp 2x2 mesh (3), each with exact launch counts (every
     ring op once a batch group; the replicas bitwise equal, the
     ``overlap_eval`` snapshot the actor), then held round by round
     against a single-device twin of the same seed, each round from the
     twin's carry (``ptr``/``size`` exactly, the actor, the Q stack and
     the critic loss within rtol 1e-3, atol 1e-5, under PER one update a
     round and every draw exactly); the ac 2x2 path under
     ``sanitize``; a mesh preempted at round 8 and resumed, bitwise equal
     to the uninterrupted mesh run; ``python -m
     repro_torch.examples.train_sac_pendulum --seconds 3 --no-adapt``,
     then with ``--mesh 2x1``, which must exit non-zero with
     ``make_ac_mesh``'s message; ``update_hz`` of the ac 2x2 mesh and of
     one device in turns, labelled one-card stand-in (no dual-card
     rate); the bench (phase 3) runs its sharded arms over eight cuda:0
     entries;
  7. hold the LM model kernels (rmsnorm, flash_attention,
     decode_attention) against their plain versions on the card at the
     serving path's shapes, in float32 (max abs error <= 1e-5: the
     reduction order differs) and bfloat16 (within one bf16 rounding step
     of the plain result: 2**-7 relative, plus the float32 1e-5), then time
     kernel, plain version and the library call (``F.rms_norm``,
     ``F.scaled_dot_product_attention``), timing only, and flash's float32
     SIMT kernel beside its bf16 tensor-core one; rmsnorm at
     granite-4.0-h-micro's rows (``GRANITE_NORM_SHAPES``); the same for
     ``ssd_scan`` at full-width mamba2-130m's and zamba2-1.2b's prefill
     shapes, granite-4.0-h-micro's arch update (B 32, 1024 tokens, H 64,
     P 64, N 128), mamba2's width over 8 chunks, a ragged single chunk
     and a small shape (float32 within 1e-5 of the largest |plain|, since
     the scan's sums run over N and the chunk; bfloat16 one rounding step
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
     prefill and the decode step;
  10. the MoE, enc-dec and VLM families and qwen2.5-32b: flash attention
     at whisper-medium's encoder (non-causal, 1500 frames: a tail) and
     cross shapes, mixtral-8x7b's 4096-token window over 8192, kimi's
     head_dim 112, paligemma-3b's 256 patch prefix at head_dim 256 and
     granite-4.0-h-micro's NoPE GQA (B 32, 1024 tokens, 32 heads over 8,
     q scaled by 0.125 first, ``FLASH_Q_SCALE``), and decode attention
     over paligemma's 1344-slot cache (head_dim 256) and whisper's
     1500-slot cross cache, each against its plain
     version in bf16 and float32 (as phase 7) and timed beside SDPA (an
     explicit boolean mask for the window and the prefix); serving on the
     card against the CPU (as phase 8) for reduced mixtral-8x7b,
     kimi-k2-1t-a32b, whisper-medium and paligemma-3b at float32 (tokens
     equal) and bf16, with the MoE routes of the two devices compared
     (the flipped (layer, token) routes printed); full-width
     ``greedy_generate`` (as phase 9) of whisper-medium and
     paligemma-3b, and of mixtral-8x7b (4 of 32 layers), kimi-k2-1t-a32b
     (1 of 61 layers, all 384 experts, parameters drawn in bf16) and
     qwen2.5-32b (8 of 64 layers), with exact launch counts, timed; then
     ``python -m repro_torch.examples.serve_decode --arch mixtral-8x7b``
     (the card's tokens against the CPU's, reduced);
  11. LM training of the attention families: the backward kernels
     (``rmsnorm_bwd``, ``flash_attention_bwd``, and the forward's LSE)
     against their plain versions at qwen2-0.5b's training shape (B 8,
     1024 tokens, 14 heads over 2, d 64; norms of 8192 x 896), a window
     of 256, whisper-medium's encoder and cross shapes, kimi's d 112,
     paligemma's 256-patch prefix at d 256, granite-4.0-h-micro's NoPE
     GQA (q scaled first) and rows that see no key, norms at granite's
     rows (``GRANITE_NORM_SHAPES``), in
     float32 (within 1e-4 of the largest gradient value) and bf16 (1e-2),
     then timed beside their bounds, their plain versions and the
     library's backward (``F.rms_norm``'s and SDPA's, by
     ``torch.autograd.grad`` on a retained graph); 8 full-width
     qwen2-0.5b train steps through ``train_loop`` (f32 parameters, bf16
     compute, adamw, clip 1.0, remat; batches of 8 x 1024 from
     ``batch_iterator``) with the exact launches of every step
     (``TRAIN_STEP_LAUNCHES``), then 8 on one repeated batch, whose loss
     must fall; one float32 train step of reduced qwen2-0.5b,
     h2o-danube-1.8b, mixtral-8x7b (the CPU's routing replayed; the free
     run's gap printed), whisper-medium, paligemma-3b, mamba2-130m and
     zamba2-1.2b (3 layers; the SSMs over three chunks of 32) on the card
     against the CPU (loss, gradients and the new parameters, within
     ``tests/test_torch_trainer.py``'s limits); one full-width step under
     ``torch.cuda.set_sync_debug_mode("error")``; and ``python -m
     repro_torch.launch.train lm --arch qwen2-0.5b --steps 3 --batch 2
     --seq 128``;
  12. SSM and hybrid training: the scan's backward kernel
     (``ssd_scan_bwd``) against its plain version on the chunk-start
     states of the forward kernel, at mamba2-130m's and zamba2-1.2b's
     training shapes (B 8, 1024 tokens, chunk 256; H 24, P 64, N 128 and
     H 64, P 64, N 64), granite-4.0-h-micro's arch update (B 32, H 64,
     P 64, N 128), one ragged chunk of 80, and P 24, N 20 over
     chunks of 32 from an initial state with a final state's gradient,
     in bf16 and float32, each gradient within ``GRAD_TOL`` of its
     largest value, and that forward (with its initial state and its
     states) against ``ssd_scan_ref``; then timed at mamba2's training
     shape beside its bound and its plain version, with the serving and
     training forwards and their device launches; full-width mamba2-130m
     (8 steps) and zamba2-1.2b (4 steps) through ``train_loop`` as in
     phase 11, with exact launches (``SSM_TRAIN_LAUNCHES``) and the loss
     falling on a repeated batch; one mamba2 step under the sync debug
     mode "error"; and ``python -m repro_torch.launch.train lm --arch
     mamba2-130m --steps 3 --batch 2 --seq 256``;
  13. the RL towers on LM backbones (``rl.networks``' arch towers,
     ``core.model_parallel.make_arch_spreeze_losses``): both losses'
     gradients (the actor's over the actor, the critics' over the stacked
     critics) on the card against the CPU for reduced qwen2-0.5b,
     mixtral-8x7b (the CPU's routing replayed), whisper-medium,
     paligemma-3b, mamba2-130m and zamba2-1.2b (3 layers) at float32,
     within ``ARCH_RL_TOL`` of each leaf's largest value; the
     ``repro_torch.examples.llm_rl`` step on the card against the CPU's
     from the same towers and draws (3 steps), then its whole run with
     exact launches (``example_launches``) and its check holding on the
     card (``llm_rl.warmup_check``: the critic loss's mean over the last
     10 warm-up steps below that over the first 10; the reward's gain is
     printed, not checked: rounding decides it, ``run_arch_rl_example``);
     full-width smollm-360m towers (an actor, two critics, their targets;
     f32 parameters, bf16 compute) at ``lower_spreeze_arch``'s shape
     (batch 32 x 1024, act_dim 16): ``make_arch_spreeze_update`` once,
     then 3 timed updates with exact launches (``arch_update_launches``),
     finite losses, parameters and Adam moments, ms an update, tokens,
     peak memory and model FLOPs over the wall against 989 TFLOP/s; the
     same for granite-4.0-h-micro's towers (the benchmark's granite cell:
     one period of its ``layer_types``, 9 Mamba-2 layers and one NoPE
     GQA layer at the published widths, ``granite_config``), with the
     interleaved family's exact launches
     (``interleaved_update_launches``), no model FLOPs;
  14. the dry run (``repro_torch.launch.dryrun``'s census,
     ``launch.analysis.OpCensus``) on the meta device against the card,
     for each of ``DRY_STEPS``: qwen2-0.5b's train step (8 x 1024), its
     prefill and one decode step at the serving shape, mamba2-130m's
     train step and one full-width smollm-360m arch RL update: the
     census's kernel calls equal the wrappers' launches exactly, its aten
     FLOPs ``FlopCounterMode``'s on the card exactly, its peak of
     temporaries within ``DRY_MEM_TOL`` of ``max_memory_allocated()``
     above what was allocated before the step; each step's roofline bound
     (``kernels/work.py``'s work and the aten ops' bytes and FLOPs over
     the card's data-sheet rates) printed beside its measured wall;
  15. the port's two linters on the card (``run_linters``): every hlolint
     contract (``repro_torch.analysis.hlolint``: the trainer's megasteps,
     one device and the 2 x 4 stand-in grid, uniform and PER, the sampler
     chunk, the update round, the ring write, the sharded gather and
     top-k, the finite guard, the LM train and decode steps) built at its
     probe size on the card and driven under the sync debug mode "error":
     no finding (in place, moves, dtypes, host reads, launches), each
     kernel's ``LAUNCH_COUNTS`` per dispatch equal to the contract's
     expression and to the meta census's count, one line a contract;
     the coverage scan of ``src/repro_torch`` clean; the fixture corpus's
     host-read entry caught on the card; ``python -m
     repro_torch.analysis.tracelint`` over ``src/repro_torch`` exiting 0;
     the sync debug mode as it was before the phase.
Every bound is ``kernels/work.py``'s work over the rates of
``launch/analysis.py`` (``analysis.bound_ms``).
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
# the card's data-sheet rates (NVIDIA H100 80GB HBM3) and each kernel's
# work: launch/analysis.py and kernels/work.py, which the dry run reads too
from repro_torch.kernels import work as kwork  # noqa: E402
from repro_torch.launch.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S,
    PEAK_FLOPS_F32 as F32_FLOP_PER_S, backbone_flops, bound_ms)
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
# granite-4.0-h-micro: the benchmark's granite cell's backbone, whose arch
# update (phase 13) runs its scan, flash attention and norms at the shapes
# below: batch 32 x 1024, the Mamba-2 mixers' 64 heads of 64 with N 128
# and chunk 256, GQA 32 / 8 of 64 with q scaled by its attention
# multiplier times sqrt(64), 0.125, before the kernel
GRANITE_ARCH = "granite-4.0-h-micro"
# (B, S, H, P, N, chunk) of each SSM's prefill scan at the serving shape,
# and of granite's arch update
SCAN_SHAPES = {"mamba2-130m": (SERVE_B, SERVE_PROMPT, 24, 64, 128, 256),
               "zamba2-1.2b": (SERVE_B, SERVE_PROMPT, 64, 64, 64, 256),
               GRANITE_ARCH: (32, 1024, 64, 64, 128, 256)}
# granite's norms (eps 1e-5): (rows, width) of ln1 and ln2 (d 2048), the
# Mamba-2 mixer's gated norm (d_inner 4096) and ln_f at the last position
GRANITE_NORM_SHAPES = ((32 * 1024, 2048), (32 * 1024, 4096), (32, 2048))
GRANITE_EPS = 1e-5
# Exact launches of one greedy_generate at the serving shape (64 new
# tokens: 65 forwards). dense: 2L + 1 norms a forward, L flash (prefill),
# L decode attentions a step, a rope (q and k) before each attention. ssm:
# L pre-norms, L gated norms and ln_f a forward, L scans (prefill).
# hybrid: its 38 core layers as ssm, plus 7 shared-block calls, each with
# 2 norms, a rope and a flash (prefill) or a decode attention (a step): 91
# norms a forward.
SERVE_LAUNCHES = {
    "qwen2-0.5b": {"rmsnorm": 3185, "rope": 24 + 1536,
                   "flash_attention": 24, "decode_attention": 1536},
    "mamba2-130m": {"rmsnorm": 3185, "ssd_scan": 24},
    "zamba2-1.2b": {"rmsnorm": 5915, "rope": 7 + 448, "flash_attention": 7,
                    "decode_attention": 448, "ssd_scan": 38},
    # moe / vlm / dense as qwen2 at their depths; whisper: LayerNorms (no
    # rmsnorm) and no rope, 24 encoder + 24 self + 24 cross flash
    # attentions in the prefill, 24 self + 24 cross decode attentions a
    # step
    "mixtral-8x7b": {"rmsnorm": 585, "rope": 4 + 256, "flash_attention": 4,
                     "decode_attention": 256},
    "kimi-k2-1t-a32b": {"rmsnorm": 195, "rope": 1 + 64,
                        "flash_attention": 1, "decode_attention": 64},
    "whisper-medium": {"flash_attention": 72, "decode_attention": 3072},
    "paligemma-3b": {"rmsnorm": 2405, "rope": 18 + 1152,
                     "flash_attention": 18, "decode_attention": 1152},
    "qwen2.5-32b": {"rmsnorm": 1105, "rope": 8 + 512, "flash_attention": 8,
                    "decode_attention": 512},
}
# The new families' full-width serving runs: (layers kept, or None for
# all; the parameters' dtype). mixtral's 32 layers (1.45 B parameters a
# layer), kimi's 61 (17.0 B a layer: 68 GB at float32 alone) and
# qwen2.5-32b's 64 (0.49 B a layer) do not fit one 80 GB card at 6 bytes
# a parameter (float32 and the bf16 compute copy).
NEW_SERVE_RUNS = {"whisper-medium": (None, "float32"),
                  "paligemma-3b": (None, "float32"),
                  "mixtral-8x7b": (4, "float32"),
                  "kimi-k2-1t-a32b": (1, "bfloat16"),
                  "qwen2.5-32b": (8, "float32")}
# Flash attention at the new families' serving shapes (8 prompts of 1024
# text tokens): (label, B, Sq, Sk, H, KV, d, causal, window, prefix_len)
NEW_FLASH_SHAPES = (
    ("whisper-medium encoder", 8, 1500, 1500, 16, 16, 64, False, None, None),
    ("whisper-medium cross", 8, 1024, 1500, 16, 16, 64, False, None, None),
    ("mixtral-8x7b window", 1, 8192, 8192, 32, 8, 128, True, 4096, None),
    ("kimi-k2 d 112", 8, 1024, 1024, 64, 8, 112, True, None, None),
    ("paligemma-3b prefix", 8, 1280, 1280, 8, 1, 256, True, None, 256),
    ("granite-4.0-h-micro arch update", 32, 1024, 1024, 32, 8, 64, True,
     None, None),
)
# q's scale before the kernel, by shape label (1 elsewhere): granite's
# attention multiplier times sqrt(head_dim), a power of two
FLASH_Q_SCALE = {"granite-4.0-h-micro arch update": 0.125}
# LM training: qwen2-0.5b, 8 x 1024 tokens a step, 8 steps
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen2-0.5b", 8, 1024, 8
# Exact launches of one qwen2-0.5b train step (24 layers, remat on): the
# forward's 2 norms, 1 rope and 1 flash attention a layer and the final
# norm, the backward's recompute of each checkpointed layer (its 2 norms,
# its rope and its flash attention once more), and one backward launch of
# each norm, rope and attention the loss reaches
TRAIN_STEP_LAUNCHES = {"rmsnorm": 2 * 24 + 1 + 2 * 24, "rmsnorm_bwd": 49,
                       "rope": 48, "rope_bwd": 24,
                       "flash_attention": 48, "flash_attention_bwd": 24}
# The backward kernels' checks: (label, B, Sq, Sk, H, KV, d, causal,
# window, prefix_len); the first is qwen2-0.5b's training shape
BWD_FLASH_SHAPES = (
    ("qwen2-0.5b train", 8, 1024, 1024, 14, 2, 64, True, None, None),
    ("window 256", 2, 1024, 1024, 14, 2, 64, True, 256, None),
    ("whisper-medium encoder", 2, 1500, 1500, 16, 16, 64, False, None,
     None),
    ("whisper-medium cross", 2, 1024, 1500, 16, 16, 64, False, None, None),
    ("kimi-k2 d 112", 2, 1024, 1024, 64, 8, 112, True, None, None),
    ("paligemma-3b prefix", 2, 1280, 1280, 8, 1, 256, True, None, 256),
    ("rows that see no key", 1, 70, 30, 4, 2, 64, True, None, None),
    ("granite-4.0-h-micro arch update", 32, 1024, 1024, 32, 8, 64, True,
     None, None),
)
# a backward kernel's largest error, relative to the largest gradient
# value: its sums run over the sequence and the G heads in another order
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the forward's row logsumexp against attention_ref's, where finite (the
# bf16 forward sums ex2.approx terms; tests/test_torch_cuda.py's limits)
LSE_TOL = {"rtol": 1e-5, "atol": 1e-4}
# card against CPU, one float32 train step: (arch, sequence length, a
# VLM's counting its patches, layers of the reduced config), as
# tests/test_torch_trainer.py; the SSMs over three chunks of 32, zamba2's
# 3 layers in two groups, (0, 2) and (2, 3), each after the shared block.
# (At 5 layers the gradient of A_log, a sum over every row and head that
# nearly cancels, lies 3.2e-5 of its largest value from the CPU's, and
# 3.9e-5 with every kernel swapped for its plain version on the card:
# the card's summation order, not a kernel, moves it past 2e-5.)
TRAIN_CHECKS = (("qwen2-0.5b", 32, 2), ("h2o-danube-1.8b", 80, 2),
                ("mixtral-8x7b", 80, 2), ("whisper-medium", 24, 2),
                ("paligemma-3b", 40, 2), ("mamba2-130m", 96, 2),
                ("zamba2-1.2b", 96, 3))
# SSM and hybrid training, 8 x 1024 tokens a step: (arch, steps a run).
# Exact launches of one step (remat on): mamba2-130m's 24 layers each run
# ln1, the gated norm and the scan in the forward and again in the
# backward's recompute, plus the final norm; one backward launch of each
# norm and scan. zamba2-1.2b adds, before each of its 7 groups of core
# layers (38 in all), the shared attention block, not checkpointed: 2
# norms, a rope and a flash attention, each with its backward.
SSM_TRAIN_RUNS = (("mamba2-130m", 8), ("zamba2-1.2b", 4))
SSM_TRAIN_LAUNCHES = {
    "mamba2-130m": {"rmsnorm": 2 * (2 * 24) + 1, "rmsnorm_bwd": 2 * 24 + 1,
                    "ssd_scan": 2 * 24, "ssd_scan_bwd": 24},
    "zamba2-1.2b": {"rmsnorm": 2 * (2 * 38) + 2 * 7 + 1,
                    "rmsnorm_bwd": 2 * 38 + 2 * 7 + 1,
                    "rope": 7, "rope_bwd": 7,
                    "flash_attention": 7, "flash_attention_bwd": 7,
                    "ssd_scan": 2 * 38, "ssd_scan_bwd": 38},
}
# The scan backward's checks: (label, B, S, H, P, N, chunk, initial state
# and dfinal given); the first two are the training shapes
BWD_SCAN_SHAPES = (
    ("mamba2-130m train", TRAIN_B, TRAIN_S, 24, 64, 128, 256, False),
    ("zamba2-1.2b train", TRAIN_B, TRAIN_S, 64, 64, 64, 256, False),
    ("one ragged chunk of 80", 2, 80, 4, 32, 32, 256, True),
    ("P 24, N 20, chunks of 32", 2, 96, 4, 24, 20, 32, True),
    ("granite-4.0-h-micro arch update", 32, 1024, 64, 64, 128, 256, False),
)
# The RL towers on LM backbones (phase 13). Card against CPU: (arch,
# tokens a sequence, layers of the reduced config), float32, both arch
# losses' gradients within ARCH_RL_TOL of each leaf's largest value
# (tests/test_torch_arch_rl.py's limit against the reference); the SSMs
# over two chunks of 32, zamba2's 3 layers in two groups
ARCH_RL_CHECKS = (("qwen2-0.5b", 16, 2), ("mixtral-8x7b", 16, 2),
                  ("whisper-medium", 16, 2), ("paligemma-3b", 16, 2),
                  ("mamba2-130m", 64, 2), ("zamba2-1.2b", 64, 3))
ARCH_RL_TOL = 2e-5
# The full-width update at lower_spreeze_arch's shape
# (src/repro/launch/dryrun.py:288): smollm-360m, batch 32, 1024 tokens,
# 16 action dimensions; one warm-up update, then ARCH_RL_UPDATES timed
ARCH_RL_ARCH, ARCH_RL_B, ARCH_RL_S, ARCH_RL_ACT = "smollm-360m", 32, 1024, 16
ARCH_RL_UPDATES = 3
# rope on the card, bit-equal to its plain version, forward and backward:
# (label, B, S, heads, kv heads, head_dim, theta, position dtype, first
# position): smollm-360m's training rows (timed too), qwen2-0.5b's serving
# prefill (an int64 arange) and its decode step (the int32 cache position,
# q alone too, as under cross attention)
ROPE_SHAPES = (
    ("smollm train", ARCH_RL_B, ARCH_RL_S, 15, 5, HEAD_DIM, 1e4, "int64", 0),
    ("qwen2 prefill", SERVE_B, SERVE_PROMPT, HEADS, KV_HEADS, HEAD_DIM,
     1e6, "int64", 0),
    ("qwen2 decode", SERVE_B, 1, HEADS, KV_HEADS, HEAD_DIM, 1e6, "int32",
     SERVE_PROMPT + 7))


def arch_update_launches(layers):
    """Exact launches of one arch update of a dense backbone (remat on):
    5 backbone forwards (the critic loss's 2 critics, the actor and the 2
    target critics; the actor loss takes the actor's and the critics'
    from them), each 2 norms, a rope and a flash attention a layer and
    ``ln_f``; then the 3 differentiated towers' backward, which recomputes
    each checkpointed layer (its 2 norms, its rope and its flash
    attention) and runs one backward of every norm, rope and attention."""
    n = 2 * layers + 1
    return {"rmsnorm": 5 * n + 3 * 2 * layers, "rmsnorm_bwd": 3 * n,
            "rope": 5 * layers + 3 * layers, "rope_bwd": 3 * layers,
            "flash_attention": 5 * layers + 3 * layers,
            "flash_attention_bwd": 3 * layers}


def interleaved_update_launches(layer_types):
    """Exact launches of one arch update of an interleaved backbone
    (``layer_types``, remat on), as ``arch_update_launches``: each of the
    5 forwards runs, a Mamba-2 layer, ln1, the mixer's scan and gated
    norm and ln2, and an attention layer (NoPE: no rope) its 2 norms and
    a flash attention, then ``ln_f``; the 3 differentiated towers'
    backward recomputes every checkpointed layer and runs one backward of
    each norm, scan and attention."""
    m = sum(t == "mamba" for t in layer_types)
    a = len(layer_types) - m
    n = 3 * m + 2 * a + 1
    return {"rmsnorm": 5 * n + 3 * (n - 1), "rmsnorm_bwd": 3 * n,
            "ssd_scan": 8 * m, "ssd_scan_bwd": 3 * m,
            "flash_attention": 8 * a, "flash_attention_bwd": 3 * a}


def granite_config():
    """granite-4.0-h-micro cut to one period of its ``layer_types`` (9
    Mamba-2 layers, one attention layer), every width as published: the
    benchmark's granite cell's backbone."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(GRANITE_ARCH)
    n = cfg.period()
    return dataclasses.replace(cfg, num_layers=n,
                               layer_types=cfg.layer_types[:n])


def example_launches(layers, steps, warmup, every):
    """Exact launches of ``repro_torch.examples.llm_rl`` (a dense backbone
    of ``layers``, remat on). Each step: the actor's forward, the 2
    critics' forwards and their backward (recompute and backward kernels),
    and the 2 critics' backbones in the actor loss, without a graph; from
    step ``warmup`` on also the actor's backward. And one actor forward
    for the initial reward, each printout and the final reward. A rope
    runs before every flash attention, and its backward with every flash
    backward."""
    n = 2 * layers + 1
    actor_steps = steps - warmup
    evals = 2 + -(-steps // every)
    flash = steps * (5 * layers + 2 * layers) + actor_steps * layers \
        + evals * layers
    flash_bwd = steps * 2 * layers + actor_steps * layers
    return {"rmsnorm": steps * (5 * n + 2 * 2 * layers)
            + actor_steps * 2 * layers + evals * n,
            "rmsnorm_bwd": steps * 2 * n + actor_steps * n,
            "rope": flash, "rope_bwd": flash_bwd,
            "flash_attention": flash, "flash_attention_bwd": flash_bwd}


# Decode attention: (label, B, S, H, KV, d, valid slots checked); timed
# with every slot valid
NEW_DECODE_SHAPES = (
    ("paligemma-3b cache", 8, 1344, 8, 1, 256, 1281),
    ("whisper-medium cross cache", 8, 1500, 16, 16, 64, 1500),
)


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

    w = kwork.ring_write(ROUND_ROWS, sum(FIELD_WIDTHS.values()) * 4)
    return {"ms": event_ms(kernel), "plain_ms": event_ms(plain),
            "library_ms": event_ms(library), "bound_ms": bound_ms(w)[0]}


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

    w = kwork.ring_gather(BATCH, sum(FIELD_WIDTHS.values()) * 4,
                          distinct=int(torch.unique(idx).numel()))
    return {"ms": event_ms(kernel), "plain_ms": event_ms(plain),
            "library_ms": event_ms(library), "bound_ms": bound_ms(w)[0]}


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

    w = kwork.per_topk(CAPACITY, BATCH)
    return {"ms": event_ms(lambda: rops.per_topk(pri, gumbel, ALPHA, BATCH)),
            "plain_ms": event_ms(
                lambda: rops.per_topk_ref(pri, gumbel, ALPHA, BATCH)),
            "library_ms": event_ms(library),
            "library": "score ops + torch.topk(sorted=True)",
            "bound_ms": bound_ms(w)[0],
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
    w = kwork.priority_scatter(BATCH, int(torch.unique(idx).numel()))
    return {"ms": event_ms(lambda: rops.priority_scatter(pri, idx, vals)),
            "plain_ms": event_ms(
                lambda: rops.priority_scatter_ref(pri, idx, vals)),
            "library_ms": event_ms(
                lambda: pri.index_put_((idx_long,), vals)),
            "library": "index_put_", "bound_ms": bound_ms(w)[0]}


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
    w = kwork.per_scores(CAPACITY)
    return {"ms": event_ms(lambda: rops.per_scores(pri, gumbel, ALPHA)),
            "plain_ms": event_ms(
                lambda: rops.per_scores_ref(pri, gumbel, ALPHA)),
            "library_ms": None, "library": "none (no single PyTorch call)",
            "bound_ms": bound_ms(w)[0]}


def run_bench(dev, tiny):
    """The port's replay-kernel bench (``repro_torch.benchmarks.
    replay_kernels``), one preset, with the counters reset just before
    and read just after: each arm's kernel runs 1 + WARMUP + iters times
    (its check, the warm-up, the timed calls), ``per_scores`` in two arms
    (its own and ``global_topk``), ``per_topk`` 4 more times (the
    two-phase check), and each sharded arm (``per_scores_sharded``,
    ``per_topk_sharded`` over eight cuda:0 entries: 4 batch groups) once
    a group a call. Every oracle check must hold."""
    from repro_torch.benchmarks import replay_kernels as bench
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    reset_launch_counts()
    report, ok = bench.run(tiny=tiny, device=dev,
                           mesh_devices=["cuda:0"] * bench.MESH_DEVICES)
    launches = dict(LAUNCH_COUNTS)
    require(ok and report["oracle_ok"], f"bench oracle failed: {report}")
    calls = 1 + bench.WARMUP + report["config"]["iters"]
    # the sharded arms: once a batch group of the (2, 4) ac mesh
    groups = 4
    expect = {"ring_write": calls, "ring_write_rowloop": calls,
              "ring_gather": calls, "ring_gather_rowloop": calls,
              "per_scores": (2 + groups) * calls,
              "per_topk": (1 + groups) * calls + bench.WINDOWS}
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


def run_resume_path(rops, root, megasteps, preempt_round, prioritized=False,
                    mesh_shape=None):
    """SAC at full width with eval inline every 8 rounds: ``megasteps``
    megasteps without a stop, then the same run preempted at
    ``preempt_round`` (``FaultPlan``) and resumed from its snapshot. The
    resumed trainer equals the uninterrupted one bit for bit: every leaf
    of the state, the ring and the env states, the draw state, the
    counters and the eval history. Under PER a draw from one fixed
    Gumbel field then picks the same rows on both. With ``mesh_shape``
    all three run on that one-card stand-in mesh (placement "ac"), and
    every ring op launches once a batch group."""
    import torch
    from repro_torch.core import SpreezeTrainer, faults
    from repro_torch.replay import prioritized as per
    kw = dict(eval_every_rounds=8, async_eval=False, prioritized=prioritized,
              per_alpha=ALPHA, per_beta=0.4)
    per_round, rounds = 16 * 32, megasteps * 4
    frames = 2048 + rounds * per_round
    label = "PER" if prioritized else "uniform"
    groups = 1
    if mesh_shape is not None:
        kw.update(mesh=card_mesh(*mesh_shape), placement="ac")
        groups = mesh_shape[1]
        label += f", ac {mesh_shape[0]}x{mesh_shape[1]}"


    out, launches = {"megasteps": megasteps, "preempt_round": preempt_round}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    ref = SpreezeTrainer(full_config(**kw))
    hist_ref, counts, out["wall_s"] = counted_train(
        rops, f"resume {label}, uninterrupted", ref,
        mesh_launches(groups, rounds, prioritized), max_frames=frames)
    add(counts)
    snap_dir = os.path.join(root, label.replace(", ", "_"))
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
    expect = mesh_launches(groups, preempt_round, prioritized)
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
        mesh_launches(groups, rounds - preempt_round, prioritized,
                      warm_chunks=0),
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


# --------------------------------------------------------------------------- #
# the multi-device megastep, on a mesh that names the card several times
# --------------------------------------------------------------------------- #

def card_mesh(ac, batch):
    """The one-card stand-in: an (ac, batch) mesh naming cuda:0 at every
    position. It runs every group's kernels on real shards with real
    window offsets; it says nothing about two cards."""
    from repro_torch.launch.mesh import make_ac_mesh
    return make_ac_mesh(ac, batch, devices=["cuda:0"] * (ac * batch))


def check_sharded_ops(dev):
    """The sharded wrappers at G 2 and 8 (dp meshes over cuda:0 repeated)
    against the single-device kernels on the whole pool, at the training
    path's shapes: a round's write wrapping at the ring's end (the six
    fields and the priorities' (capacity, 1) view), an update's gather
    (seven fields) and a scatter with repeated indices, bit for bit;
    ``per_topk_sharded``'s scores bit for bit and its indices on every
    finite slot (a full pool, and 5000 live rows with ties)."""
    import torch
    from repro_torch.distributed.sharding import trainer_rules
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(21)
    shapes = [() if w == 1 else (w,) for w in FIELD_WIDTHS.values()] + [(1,)]
    checked = []
    for groups in (2, 8):
        rules = trainer_rules(card_mesh(2, groups // 2), "dp")
        rows = CAPACITY // groups

        def split(x):
            return [x[i * rows:(i + 1) * rows].clone()
                    for i in range(groups)]

        datas = [torch.randn((CAPACITY,) + s, generator=g, device=dev)
                 for s in shapes]
        batches = [torch.randn((ROUND_ROWS,) + s, generator=g, device=dev)
                   for s in shapes]
        ptr = torch.tensor(CAPACITY - ROUND_ROWS // 2, dtype=torch.int32,
                           device=dev)
        want = kops.ring_write_fields([d.clone() for d in datas], batches,
                                      ptr)
        shards = [split(d) for d in datas]
        kops.ring_write_fields_sharded([list(f) for f in zip(*shards)],
                                       batches, ptr, rules)
        require(all(torch.equal(torch.cat(s), w)
                    for s, w in zip(shards, want)),
                f"ring_write_fields_sharded (G {groups}) differs")
        idx = torch.randint(0, CAPACITY, (BATCH,), generator=g, device=dev,
                            dtype=torch.int32)
        fields = want                # the written pools
        want = kops.ring_gather_fields(fields, idx)
        outs = kops.ring_gather_fields_sharded(
            [list(f) for f in zip(*[split(d) for d in fields])], idx, rules)
        require(all(torch.equal(torch.cat([o[f] for o in outs]), w)
                    for f, w in enumerate(want)),
                f"ring_gather_fields_sharded (G {groups}) differs")
        pri = torch.rand(CAPACITY, generator=g, device=dev)
        sidx = torch.cat([idx[:BATCH // 2], idx[:BATCH // 2]])
        vals = torch.rand(BATCH, generator=g, device=dev)
        want = kops.priority_scatter(pri.clone(), sidx, vals)
        shards = split(pri)
        kops.priority_scatter_sharded(shards, sidx, vals, rules)
        require(torch.equal(torch.cat(shards), want),
                f"priority_scatter_sharded (G {groups}) differs")
        for live, ties in ((CAPACITY, ()), (5000, (7, 4095, 100_000))):
            pri, gumbel = _per_pool(dev, g, CAPACITY, live, ties)
            ws, wi = kops.per_topk(pri, gumbel, ALPHA, BATCH)
            gs, gi = kops.per_topk_sharded(split(pri), gumbel, ALPHA, BATCH,
                                           rules)
            fin = torch.isfinite(ws)
            require(torch.equal(gs, ws) and torch.equal(gi[fin], wi[fin]),
                    f"per_topk_sharded (G {groups}, {live} live) differs")
        checked.append(groups)
    return checked


def mesh_launches(groups, rounds, prioritized=False, warm_chunks=4):
    """``path_launches`` once a batch group: every ring op of the mesh
    path launches once a group."""
    return {k: groups * v for k, v in path_launches(
        rounds, warm_chunks, prioritized=prioritized).items()}


# (label, algo, prioritized, placement, mesh shape, megasteps)
MESH_PATHS = (("SAC uniform, ac 2x2", "sac", False, "ac", (2, 2), 4),
              ("SAC PER, ac 2x2", "sac", True, "ac", (2, 2), 4),
              ("TD3 uniform, dp 2x2", "td3", False, "dp", (2, 2), 3),
              ("DDPG PER, dp 2x2", "ddpg", True, "dp", (2, 2), 3))
MESH_RTOL, MESH_ATOL = 1e-3, 1e-5


def sync_to(tr, twin):
    """Give the mesh trainer ``tr`` the single-device ``twin``'s whole
    carry (the state and the ring placed onto its mesh, the env states,
    the draw state), so their next megasteps start from one state."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.core import model_parallel as mp
    tr.state = mp.place_state(twin.state, tr.layout)
    tr.replay = mp.place_replay(twin.replay, tr.layout)
    tr.env_states = tree_map(torch.clone, twin.env_states)
    tr.draws.set_state(twin.draws.get_state())


def run_mesh_path(rops, label, algo, prioritized, placement, shape,
                  megasteps):
    """``train()`` at full width on the one-card stand-in mesh, eval
    inline every 16 rounds, ``overlap_eval`` on, counters reset just
    before and read just after (every ring op once a group): the
    replicas end bitwise equal and the ``overlap_eval`` snapshot is the
    actor. Then the same mesh config in lock step with a single-device
    twin of the same seed (its launches count in no path): after both
    warm up, each round of those ``megasteps`` starts from the twin's
    carry (``sync_to``), so both sample the same rows, and ends with
    ``ptr`` and ``size`` equal and the actor, the whole Q stack and the
    round's critic loss within rtol 1e-3, atol 1e-5; under PER every
    update draws the twin's rows exactly, and the whole priority pool
    (the groups' scatters of the round's TD errors) and ``max_priority``
    are within the same tolerance of the twin's. The PER pair runs one update a
    round, each from the twin's priorities: a later update of a round
    would rank rows by priorities that differ in the last bits, and a
    near tie reorders the draw. Left to run on, two trainers whose math
    differs only in rounding leave that tolerance within one to two
    megasteps, the env's rollouts amplifying the difference
    (``tools/mesh_drift.py``: a one-ulp change on one device does the
    same, and a PER round's later updates reorder their draws)."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import SpreezeTrainer
    from repro_torch.core import model_parallel as mp
    from repro_torch.launch.mesh import ring_shard_groups
    from repro_torch.replay import prioritized as per
    mesh = card_mesh(*shape)
    groups = ring_shard_groups(mesh, placement)
    rounds = megasteps * 4
    kw = dict(algo=algo, prioritized=prioritized, per_alpha=ALPHA,
              per_beta=0.4, eval_every_rounds=16, async_eval=False,
              overlap_eval=True)
    tr = SpreezeTrainer(full_config(mesh=mesh, placement=placement, **kw))
    hist, launches, wall = counted_train(
        rops, label, tr, mesh_launches(groups, rounds, prioritized),
        max_frames=2048 + rounds * ROUND_ROWS)
    ws = mp.whole_state(tr)
    snap = tr.last_metrics["actor_snapshot"].params
    require(not differing_leaves(snap, tr.state.actor),
            f"{label}: overlap_eval snapshot differs from the actor")
    for rep in tr.state.replicas[1:]:
        require(not differing_leaves(
            mp.gather_state(mp.PlacedState((rep,)), tr.layout), ws),
            f"{label}: the replicas differ")
    require(all(math.isfinite(r) for r in hist.eval_returns) and
            len(hist.eval_returns) == -(-rounds // 16),
            f"{label}: eval {hist.eval_returns}")
    del tr

    drawn, sample = {True: [], False: []}, per.sample

    def recording(state, gumbel, batch_size, **skw):
        out = sample(state, gumbel, batch_size, **skw)
        drawn[skw.get("rules") is not None].append(out[1].clone())
        return out

    per.sample = recording
    worst = 0.0
    try:
        k = 1 if prioritized else 4
        tr = SpreezeTrainer(full_config(mesh=mesh, placement=placement,
                                        updates_per_round=k, **kw))
        twin = SpreezeTrainer(full_config(updates_per_round=k, **kw))
        for t in (tr, twin):
            t._warmup()
        for r in range(rounds):
            sync_to(tr, twin)
            tr.megastep(rounds=1)
            twin.megastep(rounds=1)
            wr = mp.whole_replay(tr)
            ring, twin_ring = ((wr.base, twin.replay.base) if prioritized
                               else (wr, twin.replay))
            require((int(ring.ptr), int(ring.size)) ==
                    (int(twin_ring.ptr), int(twin_ring.size)),
                    f"{label}: ring cursor differs from the twin's")
            ws = mp.whole_state(tr)
            pairs = [(name, a, b) for name in ("actor", "q")
                     for a, b in zip(tree_leaves(getattr(twin.state, name)),
                                     tree_leaves(getattr(ws, name)))]
            pairs.append(("critic_loss", twin.last_metrics["critic_loss"],
                          tr.last_metrics["critic_loss"]))
            if prioritized:
                # the round's draws were scattered back by each group into
                # its own shard: the whole pool and its running max
                pairs += [(name, getattr(twin.replay, name),
                           getattr(wr, name))
                          for name in ("priorities", "max_priority")]
            for name, want, got in pairs:
                err = float((got - want).abs().max())
                require(got.shape == want.shape and torch.allclose(
                    got, want, rtol=MESH_RTOL, atol=MESH_ATOL),
                    f"{label}, round {r + 1}: {name} differs from the "
                    f"twin's by {err:.3g}, beyond rtol {MESH_RTOL} atol "
                    f"{MESH_ATOL}")
                worst = max(worst, err)
        rops.reset_launch_counts()
    finally:
        per.sample = sample
    out = {}
    if prioritized:
        require(len(drawn[True]) == len(drawn[False]) == rounds and
                all(torch.equal(a, b) for a, b in zip(drawn[True],
                                                      drawn[False])),
                f"{label}: an update drew other rows than the twin's")
        out["draws_equal"] = rounds
    out.update({"megasteps": megasteps, "groups": groups,
                "max_abs_diff_vs_one_device": worst,
                "update_hz": hist.update_hz, "wall_s": wall,
                "eval_returns": hist.eval_returns})
    del tr, twin
    torch.cuda.empty_cache()
    return out, launches


def run_mesh_sanitized(rops, rounds=8):
    """Phase 2's config (SAC uniform, ac 2x2) with ``sanitize=True``: its
    megasteps run under sync debug mode "error" with no raise, so the
    mesh path reads nothing back to the host."""
    import torch
    from repro_torch.core import SpreezeTrainer
    tr = SpreezeTrainer(full_config(sanitize=True, mesh=card_mesh(2, 2),
                                    placement="ac"))
    hist, launches, wall = counted_train(
        rops, "sanitize (mesh)", tr, mesh_launches(2, rounds),
        max_frames=2048 + rounds * ROUND_ROWS)
    require(torch.cuda.get_sync_debug_mode() == 0 and hist.update_hz > 0,
            "sanitize (mesh)")
    return {"rounds": rounds, "update_hz": hist.update_hz,
            "wall_s": wall}, launches


def run_example():
    """``python -m repro_torch.examples.train_sac_pendulum --seconds 3
    --no-adapt``, as a user runs it; then the same with a mesh of one
    card more than the machine has (``--mesh 2x1`` on one card), which
    must exit non-zero with ``make_ac_mesh``'s message, never falling
    back to fewer devices."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.examples.train_sac_pendulum",
           "--seconds", "3", "--no-adapt"]
    t = time.perf_counter()
    ran = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=root, timeout=600)
    wall = time.perf_counter() - t
    require(ran.returncode == 0, f"example: {ran.stderr[-2000:]}")
    report = json.loads(ran.stdout[ran.stdout.index("{"):])
    require(report["update_frequency_hz"] > 0, f"example report {report}")
    have = torch.cuda.device_count()
    spec = f"{have + 1}x1"
    refused = subprocess.run(cmd + ["--mesh", spec], capture_output=True,
                             text=True, env=env, cwd=root, timeout=600)
    msg = f"need {have + 1} devices for an {spec} ac mesh, found {have}"
    require(refused.returncode != 0 and msg in refused.stderr,
            f"example --mesh {spec}: rc {refused.returncode}, "
            f"{refused.stderr[-2000:]}")
    return report, wall, spec, msg


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
    shapes and around them, bf16 and f32 (``kops.rope`` at
    ``ROPE_SHAPES``, ``torch.equal``; rmsnorm at ``GRANITE_NORM_SHAPES``
    too). Returns the max abs error of each
    kernel over its cases."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rope as R
    worst = {"rmsnorm": 0.0, "flash_attention": 0.0,
             "decode_attention": 0.0, "rope": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, S, H, KV, d, theta, pdt, at in ROPE_SHAPES:
            q, k = model_inputs(dev, S + H, dtype, (B, S, H, d),
                                (B, S, KV, d))
            pos = torch.arange(at, at + S, dtype=getattr(torch, pdt),
                               device=dev)
            pairs = [(kops.rope(q, k, pos, pos, theta),
                      R.rope_ref(q, k, pos, pos, theta))]
            if S == 1:
                pairs.append((kops.rope(q, None, pos, None, theta)[:1],
                              R.rope_ref(q, None, pos, None, theta)[:1]))
            for got, want in pairs:
                for a, b in zip(got, want):
                    worst["rope"] = max(worst["rope"], kernel_close(a, b))
                    require(torch.equal(a, b), f"rope ({label}, {dtype}) "
                            "not bit-equal to its plain version")
        # the prefill's rows (8 prompts x 1024) and a decode step's (8)
        for rows in (SERVE_B * SERVE_PROMPT, SERVE_B):
            x, = model_inputs(dev, rows, dtype, (rows, D_MODEL))
            w, = model_inputs(dev, 1, torch.float32, (D_MODEL,))
            worst["rmsnorm"] = max(worst["rmsnorm"], kernel_close(
                rms.rmsnorm(x, w), rms.rmsnorm_ref(x, w)))
        for rows, width in GRANITE_NORM_SHAPES:
            x, = model_inputs(dev, rows + width, dtype, (rows, width))
            w, = model_inputs(dev, width, torch.float32, (width,))
            worst["rmsnorm"] = max(worst["rmsnorm"], kernel_close(
                rms.rmsnorm(x, w, eps=GRANITE_EPS),
                rms.rmsnorm_ref(x, w, eps=GRANITE_EPS)))
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
    Bounds: ``kernels/work.py``'s bytes (each input read once, each
    output written once) over 3.35 TB/s or FLOPs over their type's peak
    (decode attention: its float32 FLOPs over the float32 peak), the
    larger of the two (``analysis.bound_ms``). Then ``rope`` at
    smollm-360m's training shape (``time_rope``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    bf16 = torch.bfloat16
    out = {}

    rows = SERVE_B * SERVE_PROMPT
    x, = model_inputs(dev, 11, bf16, (rows, D_MODEL))
    w, = model_inputs(dev, 12, torch.float32, (D_MODEL,))
    w_lib = w.to(bf16)
    b, by = bound_ms(kwork.rmsnorm(rows, D_MODEL, bf16))
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
    b, by = bound_ms(kwork.flash_attention(B, S, S, HEADS, KV_HEADS,
                                           HEAD_DIM, bf16))
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
    out["rope"] = time_rope(dev, "rope")
    return out


def time_rope(dev, name):
    """``rope`` or ``rope_bwd`` (``name``) at ``ROPE_SHAPES``' first row,
    smollm-360m's training q and k, bf16, beside its plain version (the
    formula the model layer ran before the kernel) and its byte bound
    (``kwork.rope``: q and k read once and written once). No PyTorch
    call does the rotation."""
    import torch
    from repro_torch.kernels import rope as R
    _, B, S, H, KV, d, theta, pdt, at = ROPE_SHAPES[0]
    q, k = model_inputs(dev, 15, torch.bfloat16, (B, S, H, d),
                        (B, S, KV, d))
    pos = torch.arange(at, at + S, dtype=getattr(torch, pdt), device=dev)
    kernel, plain = ((R.rope, R.rope_ref) if name == "rope" else
                     (R.rope_bwd, R.rope_bwd_ref))
    b, by = bound_ms(getattr(kwork, name)(B, S, S, H, KV, d,
                                          torch.bfloat16))
    return {"ms": event_ms(lambda: kernel(q, k, pos, pos, theta)),
            "plain_ms": event_ms(lambda: plain(q, k, pos, pos, theta),
                                 iters=20, warmup=3),
            "library_ms": None, "library": "none (no PyTorch call)",
            "bound_ms": b, "bound_by": by, "shape": [B, S, H, KV, d]}


def time_decode_attention(dev, B, S, H, KV, iters=200):
    """One decode step's attention, bf16, every slot of the (B, S, KV, 64)
    cache valid: kernel, plain version and SDPA. Bound
    (``kwork.decode_attention``): the bytes (K and V read once, q read and
    the output written once) over 3.35 TB/s, or the float32 operations (a
    score and its share of P V, 4 d a head and slot) over the CUDA cores'
    float32 rate, the larger."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    q, k, v = model_inputs(dev, 14, torch.bfloat16, (B, H, HEAD_DIM),
                           (B, S, KV, HEAD_DIM), (B, S, KV, HEAD_DIM))
    vl = torch.tensor(S, dtype=torch.int32, device=dev)
    q4 = q[:, :, None]
    kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
    b, by = bound_ms(kwork.decode_attention(B, S, H, KV, HEAD_DIM,
                                            torch.bfloat16))
    return {
        "ms": event_ms(lambda: dec.decode_attention(q, k, v, vl), iters),
        "plain_ms": event_ms(lambda: dec.decode_attention_ref(q, k, v, vl),
                             iters),
        "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, enable_gqa=True), iters),
        "library": "F.scaled_dot_product_attention(enable_gqa)",
        "bound_ms": b, "bound_by": by, "shape": [B, S, H, KV, HEAD_DIM]}


def sdpa_mask(dev, Sq, Sk, causal, window, prefix):
    """The boolean (Sq, Sk) mask of the same rule, for SDPA (None where no
    key is hidden)."""
    import torch
    if not causal and window is None:
        return None
    qp = torch.arange(Sk - Sq, Sk, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        m &= (qp >= kp) | (kp < (prefix or 0))
    if window is not None:
        m &= (qp - kp) < window
    return m


def check_new_attention(dev):
    """Flash and decode attention at the new families' shapes
    (``NEW_FLASH_SHAPES``, q scaled by ``FLASH_Q_SCALE`` first, and
    ``NEW_DECODE_SHAPES``), bf16 and float32,
    against their plain versions (``kernel_close``), then timed in bf16
    beside SDPA (an explicit boolean mask for a window or a prefix).
    Bounds as phase 7's (``kernels/work.py``): the bytes (each operand
    read once, the output written once) over 3.35 TB/s, the operations of
    this run's visible (query, key) pairs over the bf16 tensor peak
    (decode: float32 over the CUDA cores' rate), the larger. Returns
    (worst flash error, worst decode error, rows of results)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    rows, worst_fa, worst_dec = [], 0.0, 0.0
    for label, B, Sq, Sk, H, KV, d, causal, window, prefix in \
            NEW_FLASH_SHAPES:
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        err = 0.0
        q_scale = FLASH_Q_SCALE.get(label, 1)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = model_inputs(dev, Sq + Sk + d, dtype, (B, Sq, H, d),
                                   (B, Sk, KV, d), (B, Sk, KV, d))
            q = q * q_scale             # a power of two: exact in bf16
            err = max(err, kernel_close(fa.flash_attention(q, k, v, **kw),
                                        fa.attention_ref(q, k, v, **kw)))
            del q, k, v
            torch.cuda.empty_cache()
        worst_fa = max(worst_fa, err)
        q, k, v = model_inputs(dev, 21, torch.bfloat16, (B, Sq, H, d),
                               (B, Sk, KV, d), (B, Sk, KV, d))
        q = q * q_scale
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        mask = sdpa_mask(dev, Sq, Sk, causal, window, prefix)
        b, by = bound_ms(kwork.flash_attention(
            B, Sq, Sk, H, KV, d, torch.bfloat16, causal=causal,
            window=window, prefix_len=prefix))
        rows.append({
            "kernel": "flash_attention", "shape": label,
            "dims": [B, Sq, Sk, H, KV, d], "causal": causal,
            "window": window, "prefix_len": prefix, "max_abs_err": err,
            "ms": event_ms(lambda: fa.flash_attention(q, k, v, **kw),
                           iters=10, warmup=2),
            "plain_ms": event_ms(lambda: fa.attention_ref(q, k, v, **kw),
                                 iters=3, warmup=1),
            "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=10,
                warmup=2),
            "bound_ms": b, "bound_by": by})
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    for label, B, S, H, KV, d, valid in NEW_DECODE_SHAPES:
        err = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = model_inputs(dev, S + d, dtype, (B, H, d),
                                   (B, S, KV, d), (B, S, KV, d))
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            err = max(err, kernel_close(
                dec.decode_attention(q, k, v, vl),
                dec.decode_attention_ref(q, k, v, vl)))
        worst_dec = max(worst_dec, err)
        q, k, v = model_inputs(dev, 22, torch.bfloat16, (B, H, d),
                               (B, S, KV, d), (B, S, KV, d))
        vl = torch.tensor(S, dtype=torch.int32, device=dev)
        q4 = q[:, :, None]
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        b, by = bound_ms(kwork.decode_attention(B, S, H, KV, d,
                                                torch.bfloat16))
        rows.append({
            "kernel": "decode_attention", "shape": label,
            "dims": [B, S, H, KV, d], "max_abs_err": err,
            "ms": event_ms(lambda: dec.decode_attention(q, k, v, vl)),
            "plain_ms": event_ms(
                lambda: dec.decode_attention_ref(q, k, v, vl), iters=50),
            "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                q4, kt, vt, enable_gqa=True)),
            "bound_ms": b, "bound_by": by})
    return worst_fa, worst_dec, rows


def run_serve_example():
    """``python -m repro_torch.examples.serve_decode --arch mixtral-8x7b``
    as a user runs it: reduced, the card's tokens against the CPU's; it
    exits non-zero when they differ."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t = time.perf_counter()
    ran = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_decode",
         "--arch", "mixtral-8x7b"], capture_output=True, text=True,
        env=env, cwd=root, timeout=300)
    require(ran.returncode == 0 and "identical across devices: True" in
            ran.stdout, f"serve_decode example: {ran.stdout[-2000:]} "
            f"{ran.stderr[-2000:]}")
    return ran.stdout.strip().splitlines(), time.perf_counter() - t


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
    float32 kernels (SIMT) on the same values upcast. Bound
    (``kwork.ssd_scan``): each operand read once (x, B_, C_ as the
    reference hands them, B and C broadcast to every head; dtA float32),
    y and the final state written once, over 3.35 TB/s; the reference's
    full L x L products (C B^T, masked scores times x, C state^T and x^T
    B per chunk and head) over the bf16 tensor peak; the larger of the
    two."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N, L = SCAN_SHAPES[arch]
    args = scan_inputs(dev, 15, torch.bfloat16, B, S, H, P, N)
    f32 = [a.float() for a in args]
    w = kwork.ssd_scan(B, S, H, P, N, L, torch.bfloat16)
    b, by = bound_ms(w)
    return {"ms": event_ms(lambda: ssd.ssd_scan(*args, chunk=L), iters=20,
                           warmup=3),
            "plain_ms": event_ms(lambda: ssd.ssd_scan_ref(*args, chunk=L),
                                 iters=20, warmup=3),
            "simt_f32_ms": event_ms(lambda: ssd.ssd_scan(*f32, chunk=L),
                                    iters=20, warmup=3),
            "library_ms": None, "library": "none (no PyTorch call)",
            "bound_ms": b, "bound_by": by,
            "mbytes": w.bytes / 1e6, "gflop": w.flops / 1e9,
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


class RouteLog:
    """Records each MoE call's routing (the experts ``moe._top_k`` picks,
    and ``moe._routing``'s bf16 dispatch and combine), by call, so that
    two runs fed the same tokens can be compared route by route. Given
    another run's log (``replay``), each call hands out that run's
    dispatch and combine in place of its own (its own still recorded);
    the combine keeps its own gradient (``replayed + own - own.detach()``,
    the replayed value exactly), so a training step's router gradient
    flows as it would."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.moe, self.replay = moe, replay
        self.top_k, self.routing = moe._top_k, moe._routing
        self.experts, self.slots = [], []

    def __enter__(self):
        def top_k(probs, k):
            vals, idx = self.top_k(probs, k)
            self.experts.append(idx.reshape(-1, k).cpu())
            return vals, idx

        def routing(logits, k, capacity):
            out = self.routing(logits, k, capacity)
            if self.replay is not None:
                d, c = self.replay.slots[len(self.slots)]
                own = out[1]
                out = (d.to(logits.device),
                       c.to(logits.device) + (own - own.detach())) + out[2:]
            self.slots.append((out[0].cpu(), out[1].cpu()))
            return out

        self.moe._top_k, self.moe._routing = top_k, routing
        return self

    def __exit__(self, *exc):
        self.moe._top_k, self.moe._routing = self.top_k, self.routing


def route_flips(a, b):
    """Between two RouteLogs of the same calls: the (layer call, token)
    routes whose expert set differs, and the gate values (combine
    entries of tokens routed alike) that differ, each by one bf16
    rounding step of a gate that sits near a rounding boundary."""
    require(len(a.experts) == len(b.experts), "MoE calls differ in number")
    routes = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                 for x, y in zip(a.experts, b.experts))
    gates = sum(int(((ca != cb) & (da == db)).sum())
                for (da, ca), (db, cb) in zip(a.slots, b.slots))
    return routes, gates


def check_serving_device_vs_cpu(dev, arch, layers=2, P=40,
                                compute_dtype="float32"):
    """Reduced ``arch`` (``layers`` layers) at ``compute_dtype``, the same
    parameters and ``P``-token prompts (and frames or patches) on the card
    (kernels) and on the CPU (plain versions): the logits of the prefill
    and of 8 decode steps (both fed the CPU's tokens) agree within
    ``SERVE_LOGIT_TOL`` of the largest; at float32 greedy_generate also
    gives the same tokens (bf16 logits tie too easily for that). Returns
    the gap, its limit, and (MoE) the flips between the devices.

    The MoE rounds its gate values to bf16 (the reference's ``combine``,
    at float32 compute too), so a router logit one float32 ulp off can
    move a gate by a bf16 step (2**-8 relative): the routing is a
    discrete decision, like a top-k choice. For the MoE the logits' limit
    is held with the CPU's routing replayed on the card; the free run's
    gap, its flipped routes and its flipped gate roundings are returned
    beside it (the bf16 free run is still held to its limit)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve import engine
    cfg = get_config(arch).reduced(num_layers=layers)
    G = 8
    prefix = engine.prefix_len(cfg)
    shape = InputShape("smoke", seq_len=prefix + P, global_batch=4,
                       kind="prefill")
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
    total = prefix + P + G

    def run(where, log):
        p = factory.cast_params(to_device(params, where),
                                engine.dtype_of(compute_dtype))
        with log:
            cache, lg = engine.make_prefill_step(rc, total)(
                p, to_device(batch, where))
            cache = engine._grow_cache(cfg, cache, total)
            step = engine.make_decode_step(rc)
            out = [lg]
            for i in range(G):
                lg, cache = step(p, want_toks[:, i:i + 1].to(where), cache,
                                 torch.tensor(prefix + P + i,
                                              dtype=torch.int32,
                                              device=where))
                out.append(lg)
        return torch.stack(out).cpu().float()

    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())

    cpu_log, dev_log = RouteLog(), RouteLog()
    want = run("cpu", cpu_log)
    rel = gap(run(dev, dev_log), want)
    if cfg.family != "moe":
        require(rel <= tol, f"serving logits card vs cpu ({compute_dtype}):"
                f" {rel} > {tol}")
        return rel, tol, None
    flips = dict(zip(("routes", "gates"), route_flips(cpu_log, dev_log)),
                 free_gap=rel)
    replayed = gap(run(dev, RouteLog(replay=cpu_log)), want)
    require(replayed <= tol and (compute_dtype == "float32" or rel <= tol),
            f"serving logits card vs cpu ({compute_dtype}): {replayed} with"
            f" the CPU's routing, {rel} free, limit {tol} (flips {flips})")
    return replayed, tol, flips


def run_serving_main_path(dev, arch, layers=None, param_dtype="float32"):
    """Full-width ``arch`` (``layers`` of its layers when given, the
    parameters drawn in ``param_dtype``) through greedy_generate: counters
    reset just before, exact counts (``SERVE_LAUNCHES``) asserted just
    after. Then the prefill and the decode step are timed through the
    engine's own step functions."""
    import dataclasses

    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.models import factory
    from repro_torch.serve import engine
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    prefix = engine.prefix_len(cfg)
    shape = InputShape("serve", seq_len=prefix + SERVE_PROMPT,
                       global_batch=SERVE_B, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape)       # bf16 compute
    params = factory.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=engine.dtype_of(param_dtype))
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
    del params
    total = prefix + SERVE_PROMPT + SERVE_GEN
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
    pos = torch.tensor(prefix + SERVE_PROMPT, dtype=torch.int32,
                       device=dev)
    (logits, _), step_ms = timed(lambda: step(p, tok, cache, pos), 16)
    require(bool(torch.isfinite(logits).all()), "decode logits")
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in tree_leaves(cache))
    stats = {"arch": arch, "layers": cfg.num_layers,
             "param_dtype": param_dtype, "batch": SERVE_B,
             "prompt": SERVE_PROMPT, "prefix": prefix,
             "gen": SERVE_GEN, "params": n_params,
             "wall_s": wall, "tokens_per_s": SERVE_B * SERVE_GEN / wall,
             "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "cache_mb": cache_bytes / 1e6,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    return stats, launches


# --------------------------------------------------------------------------- #
# phase 11: LM training
# --------------------------------------------------------------------------- #

def grad_gap(got, want):
    """(max abs error, that error over the largest |want|) of a gradient
    against its plain version; the gradient must be finite."""
    import torch
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"gradient {got.dtype} {tuple(got.shape)} != plain "
            f"{want.dtype} {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), "gradient not finite")
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def check_backward_kernels(dev):
    """``rmsnorm_bwd`` at 8192 x 896 and ``GRANITE_NORM_SHAPES`` and
    ``flash_attention_bwd`` (with the forward's LSE) at
    ``BWD_FLASH_SHAPES``, q scaled by ``FLASH_Q_SCALE``, bf16 and float32,
    against their plain versions on the same inputs, each gradient within
    ``GRAD_TOL`` of its largest value; the forward's LSE is held against
    ``attention_ref``'s within ``LSE_TOL`` where finite, and the rows that
    see no key have a -inf LSE and zero gradients. ``Rope``'s backward
    (autograd through ``kops.rope``) at ``ROPE_SHAPES``, ``torch.equal``
    to ``rope_bwd_ref``. Returns ({kernel: max abs error}, {kernel:
    {dtype: largest relative gap}, "lse": {dtype: largest LSE gap}},
    rows)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rope as R
    errs = {"rmsnorm_bwd": 0.0, "flash_attention_bwd": 0.0,
            "rope_bwd": 0.0}
    rel = {"rmsnorm_bwd": {}, "flash_attention_bwd": {}, "rope_bwd": {},
           "lse": {}}
    rows = []

    def hold(name, dtype, label, got, want):
        key = "float32" if dtype == torch.float32 else "bfloat16"
        gaps = [grad_gap(a, b) for a, b in zip(got, want)]
        worst = max(g[1] for g in gaps)
        require(worst <= GRAD_TOL[key], f"{name} ({label}, {key}): "
                f"{worst} of the largest gradient > {GRAD_TOL[key]}")
        errs[name] = max(errs[name], max(g[0] for g in gaps))
        rel[name][key] = max(rel[name].get(key, 0.0), worst)
        rows.append({"kernel": name, "shape": label, "dtype": key,
                     "max_abs_err": max(g[0] for g in gaps),
                     "rel_gap": worst})
        return rows[-1]

    for dtype in (torch.bfloat16, torch.float32):
        x, dy = model_inputs(dev, 31, dtype, (TRAIN_B * TRAIN_S, D_MODEL),
                             (TRAIN_B * TRAIN_S, D_MODEL))
        w, = model_inputs(dev, 32, torch.float32, (D_MODEL,))
        hold("rmsnorm_bwd", dtype, "8192 x 896", rms.rmsnorm_bwd(x, w, dy),
             rms.rmsnorm_bwd_ref(x, w, dy))
        for n, width in GRANITE_NORM_SHAPES:
            x, dy = model_inputs(dev, n + width + 1, dtype, (n, width),
                                 (n, width))
            w, = model_inputs(dev, width + 1, torch.float32, (width,))
            hold("rmsnorm_bwd", dtype, f"granite {n} x {width}",
                 rms.rmsnorm_bwd(x, w, dy, eps=GRANITE_EPS),
                 rms.rmsnorm_bwd_ref(x, w, dy, eps=GRANITE_EPS))
            del x, dy
        for label, B, S, H, KV, d, theta, pdt, at in ROPE_SHAPES:
            q, k, dq, dk = model_inputs(dev, S + H + 1, dtype, (B, S, H, d),
                                        (B, S, KV, d), (B, S, H, d),
                                        (B, S, KV, d))
            q.requires_grad_()
            k.requires_grad_()
            pos = torch.arange(at, at + S, dtype=getattr(torch, pdt),
                               device=dev)
            got = torch.autograd.grad(kops.rope(q, k, pos, pos, theta),
                                      (q, k), (dq, dk))
            want = R.rope_bwd_ref(dq, dk, pos, pos, theta)
            hold("rope_bwd", dtype, label, got, want)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"rope_bwd ({label}, {dtype}) not bit-equal to its "
                    "plain version")
            del q, k, dq, dk, got, want
        for label, B, Sq, Sk, H, KV, d, causal, window, prefix in \
                BWD_FLASH_SHAPES:
            kw = dict(causal=causal, window=window, prefix_len=prefix)
            q, k, v, dout = model_inputs(
                dev, Sq + Sk + d + 1, dtype, (B, Sq, H, d), (B, Sk, KV, d),
                (B, Sk, KV, d), (B, Sq, H, d))
            q = q * FLASH_Q_SCALE.get(label, 1)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            _, want_lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
            require(bool((torch.isneginf(lse) == torch.isneginf(
                want_lse)).all()), f"LSE's -inf rows differ ({label})")
            seen = torch.isfinite(want_lse)
            lse_err = float((lse[seen] - want_lse[seen]).abs().max())
            require(torch.allclose(lse[seen], want_lse[seen], **LSE_TOL),
                    f"flash_attention's LSE ({label}, {dtype}): max abs "
                    f"error {lse_err} past {LSE_TOL}")
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            row = hold("flash_attention_bwd", dtype, label, got,
                       fa.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                  **kw))
            row["lse_max_abs_err"] = lse_err
            key = row["dtype"]
            rel["lse"][key] = max(rel["lse"].get(key, 0.0), lse_err)
            if causal and Sq > Sk:
                blind = Sq - Sk
                require(bool(torch.isneginf(lse[..., :blind]).all()) and
                        bool((got[0][:, :blind] == 0).all()),
                        "rows that see no key: LSE not -inf or dq not 0")
            del q, k, v, dout, out, lse, want_lse, got
            torch.cuda.empty_cache()
    return errs, rel, rows


def time_backward_kernels(dev):
    """The two backward kernels at qwen2-0.5b's training shape, bf16:
    kernel, plain version and the library's backward (``F.rms_norm``'s
    and SDPA's with ``enable_gqa``, each ``torch.autograd.grad`` on a
    retained graph). Bounds (``kernels/work.py``): the bytes (each input
    read once, each output written once) over 3.35 TB/s, or the FLOPs over
    their type's peak (flash: 2.5 times the forward's, five products
    against two, over the causal mask's visible pairs), the larger. Then
    ``rope_bwd`` at smollm-360m's training shape (``time_rope``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    bf16 = torch.bfloat16
    out = {}

    rows = TRAIN_B * TRAIN_S
    x, dy = model_inputs(dev, 41, bf16, (rows, D_MODEL), (rows, D_MODEL))
    w, = model_inputs(dev, 42, torch.float32, (D_MODEL,))
    xl = x.detach().requires_grad_()
    wl = w.to(bf16).requires_grad_()
    yl = F.rms_norm(xl, (D_MODEL,), wl, 1e-6)
    b, by = bound_ms(kwork.rmsnorm_bwd(rows, D_MODEL, bf16))
    out["rmsnorm_bwd"] = {
        "ms": event_ms(lambda: rms.rmsnorm_bwd(x, w, dy)),
        "plain_ms": event_ms(lambda: rms.rmsnorm_bwd_ref(x, w, dy)),
        "library_ms": event_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True)),
        "library": "F.rms_norm backward (bf16 weight)", "bound_ms": b,
        "bound_by": by, "shape": [rows, D_MODEL]}
    del xl, wl, yl

    B, S = TRAIN_B, TRAIN_S
    q, k, v, dout = model_inputs(dev, 43, bf16, (B, S, HEADS, HEAD_DIM),
                                 (B, S, KV_HEADS, HEAD_DIM),
                                 (B, S, KV_HEADS, HEAD_DIM),
                                 (B, S, HEADS, HEAD_DIM))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    b, by = bound_ms(kwork.flash_attention_bwd(B, S, S, HEADS, KV_HEADS,
                                               HEAD_DIM, bf16))
    out["flash_attention_bwd"] = {
        "ms": event_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout),
                       iters=10, warmup=2),
        "plain_ms": event_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, lse, dout), iters=5, warmup=1),
        "library_ms": event_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), iters=20, warmup=3),
        "library": "F.scaled_dot_product_attention(enable_gqa) backward",
        "bound_ms": b, "bound_by": by, "shape": [B, S, HEADS, HEAD_DIM],
        "forward_lse_ms": event_ms(lambda: fa.flash_attention(
            q, k, v, return_lse=True), iters=20, warmup=3),
        "forward_ms": event_ms(lambda: fa.flash_attention(q, k, v),
                               iters=20, warmup=3)}
    out["rope_bwd"] = time_rope(dev, "rope_bwd")
    return out


def train_rc(cfg, seq, batch, **kw):
    from repro_torch.configs.base import InputShape, RunConfig
    return RunConfig(model=cfg, shape=InputShape("train", seq, batch,
                                                 "train"), **kw)


def run_train_main_path(dev, arch=TRAIN_ARCH, steps=TRAIN_STEPS,
                        per_step=None):
    """Full-width ``arch`` (f32 parameters from seed 0, bf16 compute,
    adamw, clip 1.0, remat) through ``train_loop``: ``steps`` steps on
    ``batch_iterator``'s batches of 8 x 1024 tokens, then as many on one
    repeated batch, whose loss must fall; each run's launches zeroed just
    before and read just after, exactly ``per_step`` a step
    (``TRAIN_STEP_LAUNCHES`` for qwen2-0.5b)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.models import factory
    from repro_torch.train.trainer import train_loop
    cfg = get_config(arch)
    rc = train_rc(cfg, TRAIN_S, TRAIN_B)
    per_step = per_step or TRAIN_STEP_LAUNCHES
    expect = {k: n * steps for k, n in per_step.items()}
    stats, counts = {}, {}
    for label, batches in (
            ("batch_iterator", batch_iterator(cfg, rc.shape, seed=0,
                                              device=dev)),
            ("one batch repeated", itertools.repeat(next(batch_iterator(
                cfg, rc.shape, seed=1, device=dev))))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = train_loop(rc, batches, steps=steps, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCH_COUNTS)
        require(launches == expect,
                f"train launches ({arch}) {launches} != expected {expect}")
        require(len(res.losses) == steps and
                all(math.isfinite(x) for x in res.losses),
                f"losses {res.losses}")
        for name, c in launches.items():
            counts[name] = counts.get(name, 0) + c
        stats[label] = {
            "arch": arch, "params": factory.count_params_analytic(cfg),
            "batch": TRAIN_B, "seq": TRAIN_S, "steps": steps,
            "step_ms": 1e3 / res.steps_per_sec,
            "tokens_per_s": TRAIN_B * TRAIN_S * res.steps_per_sec,
            "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_loss": res.losses[0], "last_loss": res.losses[-1],
            "losses": res.losses, "launches": launches}
    rep = stats["one batch repeated"]
    require(rep["last_loss"] < rep["first_loss"],
            f"the loss on a repeated batch did not fall ({arch}): "
            f"{rep['losses']}")
    return stats, counts


def run_train_sanitized(dev, arch=TRAIN_ARCH):
    """One full-width ``arch`` train step (after a warm-up step) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in it waits for
    the card."""
    import torch
    from repro_torch import sync_debug_mode
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = get_config(arch)
    rc = train_rc(cfg, TRAIN_S, TRAIN_B)
    params, state, opt = init_train_state(
        rc, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(rc, opt)
    batches = batch_iterator(cfg, rc.shape, device=dev)
    step(params, state, next(batches))
    batch = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_debug_mode(dev, "error"):
        params, state, metrics = step(params, state, batch)
    torch.cuda.synchronize()
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"sanitized step loss {loss}")
    return {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3}


def check_training_device_vs_cpu(dev, arch, seq, layers=2):
    """Reduced ``arch`` (``layers`` deep), float32 compute: one train step
    (adamw, clip 1.0,
    remat) on the card and on the CPU from the same parameters and batch.
    The loss within 1e-5 relative, each gradient leaf within 2e-5 of its
    largest value, the new parameters within 2 lr (Adam's sign of a
    near-zero gradient) with at most 0.1% of the elements past 1e-6 +
    1e-5 |p|: ``tests/test_torch_trainer.py``'s limits. The MoE's routing
    is the CPU's, replayed (``RouteLog``); its free run's gaps and flips
    are returned beside."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import make_optimizer
    cfg = get_config(arch).reduced(num_layers=layers)
    rc = train_rc(cfg, seq, 2, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(5))
    batch = make_batch(cfg, rc.shape, torch.Generator().manual_seed(6))
    opt = make_optimizer(rc.optimizer, rc.learning_rate,
                         weight_decay=rc.weight_decay, grad_clip=rc.grad_clip)

    def run(where, log):
        p = tree_map(lambda a: a.detach().clone().to(where).requires_grad_(),
                     params)
        with log:
            loss, _, grads = trainer.value_and_grad(rc, p, to_device(batch,
                                                                     where))
        opt.update(grads, opt.init(p), p)
        return (float(loss), [g.cpu() for g in grads],
                torch.cat([a.detach().cpu().ravel() for a in tree_leaves(p)]))

    def gaps(got, want):
        loss_rel = abs(got[0] - want[0]) / abs(want[0])
        grad_rel = max(float((a - b).abs().max()) /
                       max(float(b.abs().max()), 1e-30)
                       for a, b in zip(got[1], want[1]))
        d = (got[2] - want[2]).abs()
        past = float((d > 1e-6 + 1e-5 * want[2].abs()).float().mean())
        return {"loss_rel": loss_rel, "grad_rel": grad_rel,
                "param_max": float(d.max()), "param_share_past": past}

    moe = cfg.family == "moe"
    cpu_log = RouteLog() if moe else contextlib.nullcontext()
    want = run("cpu", cpu_log)
    got = gaps(run(dev, RouteLog(replay=cpu_log) if moe
                   else contextlib.nullcontext()), want)
    require(got["loss_rel"] <= 1e-5 and got["grad_rel"] <= 2e-5 and
            got["param_max"] <= 2 * rc.learning_rate and
            got["param_share_past"] < 1e-3,
            f"train step card vs cpu ({arch}): {got}")
    if moe:
        dev_log = RouteLog()
        free = gaps(run(dev, dev_log), want)
        routes, gates = route_flips(cpu_log, dev_log)
        got["free_run"] = {**free, "routes_flipped": routes,
                           "gates_flipped": gates}
    return got


def scan_grad_inputs(dev, seed, dtype, B, S, H, P, N):
    """``scan_inputs``, and a start state ~ 0.5 N(0, 1), dy ~ N(0, 1) in
    ``dtype`` and dfinal ~ N(0, 1), float32."""
    import torch
    x, dtA, Bm, Cm = scan_inputs(dev, seed, dtype, B, S, H, P, N)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    s0 = torch.randn((B, H, P, N), generator=g, device=dev) * 0.5
    dy = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    dfin = torch.randn((B, H, P, N), generator=g, device=dev)
    return x, dtA, Bm, Cm, s0, dy, dfin


def check_ssd_scan_bwd(dev):
    """``ssd_scan_bwd`` against ``ssd_scan_bwd_ref`` at ``BWD_SCAN_SHAPES``,
    bf16 and float32, on the chunk-start states of the kernel's forward,
    each gradient within ``GRAD_TOL`` of its largest value; that forward
    (from the start state where one is given) and its states against
    ``ssd_scan_ref`` with ``scan_close``. Returns (max abs error, {dtype:
    largest relative gap}, rows)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    worst, rel, rows = 0.0, {}, []
    names = ("dx", "ddtA", "dB", "dC", "dinitial")
    for dtype in (torch.bfloat16, torch.float32):
        key = "float32" if dtype == torch.float32 else "bfloat16"
        for label, B, S, H, P, N, L, given in BWD_SCAN_SHAPES:
            x, dtA, Bm, Cm, s0, dy, dfin = scan_grad_inputs(
                dev, S * H + N + P, dtype, B, S, H, P, N)
            s0, dfin = (s0, dfin) if given else (None, None)
            fwd = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=L, initial_state=s0,
                               return_states=True)
            want = ssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=L,
                                    initial_state=s0, return_states=True)
            fwd_err = max(scan_close(a, b) for a, b in zip(fwd, want))
            got = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, fwd[2], dy, dfin,
                                   chunk=L)
            plain = ssd.ssd_scan_bwd_ref(x, dtA, Bm, Cm, fwd[2], dy, dfin,
                                         chunk=L)
            gaps = dict(zip(names, (grad_gap(a, b)
                                    for a, b in zip(got, plain))))
            if not given:
                del gaps["dinitial"]   # no start state: not returned
            gap = max(g[1] for g in gaps.values())
            require(gap <= GRAD_TOL[key], f"ssd_scan_bwd ({label}, {key}): "
                    f"{gaps} past {GRAD_TOL[key]} of the largest gradient")
            err = max(g[0] for g in gaps.values())
            worst = max(worst, err)
            rel[key] = max(rel.get(key, 0.0), gap)
            rows.append({"kernel": "ssd_scan_bwd", "shape": label,
                         "dtype": key, "max_abs_err": err, "rel_gap": gap,
                         "rel_gap_by_grad": {k: g[1]
                                             for k, g in gaps.items()},
                         "initial_state_and_dfinal": given,
                         "forward_max_abs_err": fwd_err})
            del x, dtA, Bm, Cm, dy, fwd, want, got, plain
            torch.cuda.empty_cache()
    return worst, rel, rows


def time_ssd_scan_bwd(dev):
    """``ssd_scan_bwd`` at mamba2-130m's training shape, bf16: kernel and
    plain version (CUDA events), the device launches of a call, and no
    library call (no PyTorch call computes the scan or its gradient).
    Bound: the bytes (x, dy, B_, C_ and the float32 chunk states and dtA
    read once; dx, dB, dC and ddtA written once) over 3.35 TB/s, or the
    FLOPs of the formulas over the bf16 tensor peak, the larger: per
    chunk and head the L x L products G = C B^T, D = dy x^T, (W G)^T dy,
    (W D)^T C and (W D) B, L^2 (3 N + 2 P) multiply-adds, and the state
    products R B_s, R^T x_s, S_c^T dy_t and the chunk's own adjoint term,
    4 L P N. Beside it the float32 kernels (the SIMT path) on the same
    values upcast, the serving forward (``ssd_scan``, no states handed
    back) and the training forward (``return_states``) at the same shape,
    with their device launches."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    _, B, S, H, P, N, L, _ = BWD_SCAN_SHAPES[0]
    x, dtA, Bm, Cm, _, dy, _ = scan_grad_inputs(dev, 51, torch.bfloat16, B,
                                                S, H, P, N)
    states = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=L, return_states=True)[2]
    f32 = [a.float() for a in (x, dtA, Bm, Cm)]
    dy32 = dy.float()
    w = kwork.ssd_scan_bwd(B, S, H, P, N, L, torch.bfloat16)
    b, by = bound_ms(w)

    def bwd():
        return ssd.ssd_scan_bwd(x, dtA, Bm, Cm, states, dy, chunk=L)
    return {"ms": event_ms(bwd, iters=10, warmup=2),
            "plain_ms": event_ms(lambda: ssd.ssd_scan_bwd_ref(
                x, dtA, Bm, Cm, states, dy, chunk=L), iters=5, warmup=1),
            "library_ms": None, "library": "none (no PyTorch call)",
            "bound_ms": b, "bound_by": by,
            "mbytes": w.bytes / 1e6, "gflop": w.flops / 1e9,
            "simt_f32_ms": event_ms(lambda: ssd.ssd_scan_bwd(
                *f32, states, dy32, chunk=L), iters=5, warmup=1),
            "f32_simt_bound_ms": w.flops / F32_FLOP_PER_S * 1e3,
            "device_launches": device_launches(bwd, calls=5),
            "forward_ms": event_ms(lambda: ssd.ssd_scan(x, dtA, Bm, Cm,
                                                        chunk=L),
                                   iters=20, warmup=3),
            "forward_launches": device_launches(
                lambda: ssd.ssd_scan(x, dtA, Bm, Cm, chunk=L)),
            "forward_states_ms": event_ms(lambda: ssd.ssd_scan(
                x, dtA, Bm, Cm, chunk=L, return_states=True), iters=20,
                warmup=3),
            "shape": [B, S, H, P, N, L]}


# --------------------------------------------------------------------------- #
# phase 13: the RL towers on LM backbones
# --------------------------------------------------------------------------- #

def check_arch_rl_device_vs_cpu(dev, arch, seq, layers=2, act_dim=4):
    """Reduced ``arch`` (``layers`` deep), float32 compute: the gradients
    of both arch losses (``make_arch_spreeze_losses``; the critics' over
    the stacked critics, then the actor's, which takes the critic loss's
    forwards, over the actor) on the card and on the CPU from the same
    towers and inputs, each leaf within ``ARCH_RL_TOL`` of its largest
    value, the losses within 1e-5 relative. The MoE's routing is the
    CPU's, replayed (``RouteLog``). Returns {loss: {"loss_rel",
    "grad_rel"}}."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core import model_parallel as mp
    from repro_torch.rl import networks as nets
    cfg = get_config(arch).reduced(num_layers=layers)
    gen = torch.Generator().manual_seed(7)
    towers = {"actor": nets.init_arch_policy(gen, cfg, act_dim),
              "q": nets.init_arch_ensemble_q(gen, cfg, act_dim)}
    towers["target"] = tree_map(lambda a: a * 0.99, towers["q"])
    B = 2
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (B, seq),
                                      generator=gen),
              "act": torch.tanh(torch.randn((B, act_dim), generator=gen)),
              "rew": torch.randn((B,), generator=gen),
              "done": torch.tensor([0.0, 1.0]),
              "eps": torch.randn((B, act_dim), generator=gen)}
    actor_loss, critic_loss = mp.make_arch_spreeze_losses(
        cfg, act_dim, dtype=torch.float32)

    def run(where, log):
        t = tree_map(lambda a: a.detach().to(where).requires_grad_(),
                     towers)
        x = to_device(inputs, where)
        out = {}
        with log:
            cl = critic_loss(t["q"], t["target"], t["actor"], x["tokens"],
                             x["act"], x["rew"], x["done"])
            out["critic"] = (float(cl.detach()), [g.cpu() for g in
                                         mp.tower_grads(cl, t["q"])])
            al = actor_loss(t["actor"], t["q"], x["tokens"], x["eps"])
            out["actor"] = (float(al.detach()), [g.cpu() for g in
                                        mp.tower_grads(al, t["actor"])])
        return out

    moe = cfg.family == "moe"
    cpu_log = RouteLog() if moe else contextlib.nullcontext()
    want = run("cpu", cpu_log)
    got = run(dev, RouteLog(replay=cpu_log) if moe
              else contextlib.nullcontext())
    gaps = {}
    for name in ("actor", "critic"):
        (gl, gg), (wl, wg) = got[name], want[name]
        gaps[name] = {"loss_rel": abs(gl - wl) / abs(wl),
                      "grad_rel": max(grad_gap(a, b)[1]
                                      for a, b in zip(gg, wg))}
        require(gaps[name]["loss_rel"] <= 1e-5 and
                gaps[name]["grad_rel"] <= ARCH_RL_TOL,
                f"arch {name} loss card vs cpu ({arch}): {gaps[name]} "
                f"(limit {ARCH_RL_TOL})")
    return gaps


def check_example_steps_device_vs_cpu(dev, steps=3):
    """``repro_torch.examples.llm_rl``'s step on the card against the CPU's
    from the same towers and draws (the example draws them on one CPU
    generator): ``steps`` steps, the actor held on the first (the critic
    warm-up) and moving after it. The losses within 1e-4 relative, every
    parameter within 2 lr a step and all but 0.1% of the elements within
    1e-6 + 1e-5 |p| + 1e-2 lr (Adam moves an element whose gradient is
    ~1e-9 by +-lr on either side's sign, and its moments' ratio by both
    sides' rounding where a gradient element is small):
    ``tests/test_torch_arch_rl.py``'s limits against the reference.
    -> the gaps."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.examples import llm_rl
    from repro_torch.train.optimizer import make_optimizer
    cfg = llm_rl.example_config()

    def run(where):
        draws = llm_rl.Draws(llm_rl.SEED, where)
        actor, critics = draws.towers(cfg)
        tokens, target = draws.task(cfg)
        opt = make_optimizer("adam", llm_rl.LR)
        oa, oq = opt.init(actor), opt.init(critics)
        step, _ = llm_rl.make_step(cfg, tokens, target, opt)
        losses = [[float(x) for x in step(actor, critics, oa, oq,
                                          *draws.step(i), do_actor=i >= 1)]
                  for i in range(steps)]
        return losses, torch.cat([a.detach().cpu().ravel()
                                  for a in tree_leaves((actor, critics))])

    (got_l, got_p), (want_l, want_p) = run(dev), run("cpu")
    d = (got_p - want_p).abs()
    gaps = {"loss_rel": max(abs(a - b) / abs(b) for g, w in
                            zip(got_l, want_l) for a, b in zip(g, w)),
            "param_max": float(d.max()),
            "param_share_past": float(
                (d > 1e-6 + 1e-5 * want_p.abs() + 1e-2 * llm_rl.LR)
                .float().mean())}
    require(gaps["loss_rel"] <= 1e-4 and
            gaps["param_max"] <= 2 * steps * llm_rl.LR and
            gaps["param_share_past"] < 1e-3,
            f"llm_rl steps card vs cpu: {gaps}")
    return gaps


def run_arch_rl_example(dev):
    """``repro_torch.examples.llm_rl``'s run (``run``, what ``main`` runs
    before its check) on the card, with the launches zeroed just before
    and read just after, exactly ``example_launches``, and every printed
    loss and reward finite. Its check (``llm_rl.warmup_check``: the mean
    critic loss of the last 10 warm-up steps below that of the first 10)
    must hold, as ``main`` asserts it; the reward's gain is returned, not
    checked (where tanh saturates each action component, which float32
    rounding decides: PERF.md §6). -> (its lines, launches, wall s,
    {"reward0", "final", "warmup_first", "warmup_last", "holds"})."""
    from repro_torch.examples import llm_rl
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    lines = []
    reset_launch_counts()
    t0 = time.perf_counter()
    out = llm_rl.run(dev, log=lines.append)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCH_COUNTS)
    expect = example_launches(llm_rl.example_config().num_layers,
                              llm_rl.STEPS, llm_rl.WARMUP,
                              llm_rl.PRINT_EVERY)
    require(launches == expect,
            f"llm_rl launches {launches} != expected {expect}")
    values = [out["reward0"], out["final"]] + out["critic_losses"] + \
        out["actor_losses"] + out["warmup_critic_losses"]
    require(all(math.isfinite(v) for v in values), f"llm_rl: {out}")
    first, last, holds = llm_rl.warmup_check(out["warmup_critic_losses"])
    require(holds, f"llm_rl's check: the warm-up critic loss did not fall "
                   f"(first {first}, last {last})")
    result = {"reward0": out["reward0"], "final": out["final"],
              "warmup_first": first, "warmup_last": last,
              "span": llm_rl.CHECK_SPAN, "holds": holds}
    return [ln.strip() for ln in lines if ln.strip()], launches, wall, result


def arch_rl_update_fn(dev, arch=ARCH_RL_ARCH, cfg=None):
    """Full-width ``arch`` towers, or ``cfg``'s where given (an actor, two
    critics and their two targets; float32 parameters from seed 0, bf16
    compute, remat) and a
    batch at ``lower_spreeze_arch``'s shape -> (``update()``, one
    ``make_arch_spreeze_update`` call: the critic loss's gradient over
    the critics and the actor loss's over the actor, then Adam on each;
    the trees it updates: the towers and the Adam states). ``dev`` may be
    ``meta`` (shapes only, the dry run's census)."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core import model_parallel as mp
    from repro_torch.rl import networks as nets
    from repro_torch.rl.base import AlgoHP
    from repro_torch.train.optimizer import make_optimizer
    cfg = get_config(arch) if cfg is None else cfg
    B, S, A = ARCH_RL_B, ARCH_RL_S, ARCH_RL_ACT
    dev = torch.device(dev)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(0)
    actor = nets.init_arch_policy(gen, cfg, A, device=dev)
    q = nets.init_arch_ensemble_q(gen, cfg, A, device=dev)
    q_target = tree_map(lambda a: a.clone(), q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    opt = make_optimizer("adam", AlgoHP().lr)
    opt_actor, opt_q = opt.init(actor), opt.init(q)
    update = mp.make_arch_spreeze_update(cfg, opt, A)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=dev),
             "act": torch.tanh(torch.randn((B, A), generator=gen,
                                           device=dev)),
             "rew": torch.randn((B,), generator=gen, device=dev),
             "done": (torch.rand((B,), generator=gen, device=dev)
                      < 0.1).float(),
             "eps": torch.randn((B, A), generator=gen, device=dev)}

    def one():
        return update(actor, q, q_target, opt_actor, opt_q, **batch)

    return one, (actor, q, opt_actor.mu, opt_actor.nu, opt_q.mu, opt_q.nu)


def run_arch_rl_update(dev, cfg=None):
    """``arch_rl_update_fn``'s update (smollm-360m's towers, or ``cfg``'s):
    one warm-up, then ``ARCH_RL_UPDATES`` timed ones, each synchronised,
    with the launches zeroed just before and read just after
    (``arch_update_launches`` an update, an interleaved backbone's
    ``interleaved_update_launches``). The losses, the parameters and the
    Adam moments (which sum every gradient) must be finite. Model FLOPs,
    of a dense backbone: 5 backbone forwards and the 3 differentiated
    towers' backward at twice a forward (the recompute not counted).
    -> (stats, launches)."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.models import factory
    cfg = get_config(ARCH_RL_ARCH) if cfg is None else cfg
    dense = cfg.family == "dense"
    B, S = ARCH_RL_B, ARCH_RL_S
    torch.cuda.empty_cache()
    one, trees = arch_rl_update_fn(dev, cfg=cfg)
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ms, losses = [], []
    for _ in range(ARCH_RL_UPDATES):
        t0 = time.perf_counter()
        cl, al = one()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(cl), float(al)))
    launches = dict(LAUNCH_COUNTS)
    per = (arch_update_launches(cfg.num_layers) if dense
           else interleaved_update_launches(cfg.layer_types))
    expect = {k: v * ARCH_RL_UPDATES for k, v in per.items()}
    require(launches == expect,
            f"arch update launches {launches} != expected {expect}")
    require(all(math.isfinite(x) for pair in losses for x in pair),
            f"arch update losses {losses}")
    require(all(bool(torch.isfinite(a).all()) for a in tree_leaves(trees)),
            "arch update: a parameter or an Adam moment is not finite")
    mean_ms = sum(ms) / len(ms)
    stats = {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
             "seq": S, "act_dim": ARCH_RL_ACT,
             "backbone_params": factory.count_params_analytic(cfg),
             "towers": 5, "updates": ARCH_RL_UPDATES, "update_ms": ms,
             "mean_update_ms": mean_ms, "tokens_an_update": B * S,
             "backbone_forwards_an_update": 5,
             "tokens_per_s": B * S / (mean_ms / 1e3),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "losses": losses, "launches": launches,
             "launches_an_update": per}
    if dense:
        flops = (5 + 2 * 3) * backbone_flops(cfg, B, S)
        stats.update({"model_tflop_an_update": flops / 1e12,
                      "bound_ms": flops / BF16_FLOP_PER_S * 1e3,
                      "model_flops_share_of_989_tflops":
                          flops / (mean_ms / 1e3) / BF16_FLOP_PER_S})
    del one, trees
    torch.cuda.empty_cache()
    return stats, launches


# --------------------------------------------------------------------------- #
# phase 14: the dry run on the meta device against the card
# --------------------------------------------------------------------------- #

# The steps the census of the meta device is held against the card on:
# (arch, kind); the train steps at run_train_main_path's shape (8 x 1024,
# f32 parameters, bf16 compute, adamw, remat), prefill and one decode step
# at the serving shape (8 prompts of 1024, a 1088-slot cache, bf16
# parameters), and the arch RL update at run_arch_rl_update's
DRY_STEPS = (("qwen2-0.5b", "train"), ("qwen2-0.5b", "prefill"),
             ("qwen2-0.5b", "decode"), ("mamba2-130m", "train"),
             (ARCH_RL_ARCH, "arch RL update"))
# the census's peak of temporaries against max_memory_allocated() above
# what was allocated before the step, relative to the card's
DRY_MEM_TOL = 0.10


def dry_step(dev, arch, kind):
    """``kind``'s step of full-width ``arch`` with its state and inputs
    built on ``dev`` (``cuda``, or ``meta`` for the census) -> a function
    that runs one step. The same seed on both (values matter only on the
    card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import factory
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train.trainer import init_train_state, make_train_step
    dev = torch.device(dev)
    meta = dev.type == "meta"
    if kind == "arch RL update":
        return arch_rl_update_fn(dev, arch)[0]
    cfg = get_config(arch)
    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(0)
    if kind == "train":
        rc = train_rc(cfg, TRAIN_S, TRAIN_B)
        params, state, opt = init_train_state(rc, gen, device=dev)
        batch = input_specs(cfg, rc.shape) if meta else next(
            batch_iterator(cfg, rc.shape, seed=0, device=dev))
        step = make_train_step(rc, opt)
        return lambda: step(params, state, batch)
    rc = RunConfig(model=cfg, shape=InputShape("serve", SERVE_PROMPT,
                                               SERVE_B, kind))
    params = factory.cast_params(factory.init_params(cfg, gen, device=dev),
                                 torch.bfloat16)
    total = SERVE_PROMPT + SERVE_GEN
    tokens = (SERVE_B, SERVE_PROMPT if kind == "prefill" else 1)
    tokens = torch.randint(0, cfg.vocab_size, tokens, generator=gen,
                           device=dev, dtype=torch.int32)
    if kind == "prefill":
        step = make_prefill_step(rc, total)
        args = (params, {"tokens": tokens})
    else:
        cache = factory.init_cache(cfg, SERVE_B, total, device=dev)
        pos = torch.full((), SERVE_PROMPT, dtype=torch.int32, device=dev)
        step = make_decode_step(rc)
        args = (params, tokens, cache, pos)

    def run():
        with torch.no_grad():
            return step(*args)
    return run


def check_dry_vs_card(dev, arch, kind):
    """One step's census on the meta device (``launch.analysis.OpCensus``)
    against the same step on the card: its kernel calls equal the
    wrappers' ``LAUNCH_COUNTS`` exactly and its aten FLOPs
    ``FlopCounterMode``'s exactly, both on a first step on the card
    (which also builds the kernels and the cuBLAS workspace); its peak of
    temporaries within ``DRY_MEM_TOL`` of ``max_memory_allocated()``
    above what was allocated before a second step, which is timed. ->
    the numbers, with the census's roofline bound (one card)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from repro_torch.launch import analysis
    t0 = time.perf_counter()
    fn = dry_step("meta", arch, kind)
    with analysis.OpCensus() as census:
        fn()
    meta_s = time.perf_counter() - t0
    del fn
    torch.cuda.empty_cache()
    fn = dry_step(dev, arch, kind)
    torch.cuda.synchronize()
    reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        fn()
    torch.cuda.synchronize()
    launches, aten_flops = dict(LAUNCH_COUNTS), counter.get_total_flops()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    del fn
    torch.cuda.empty_cache()
    roof = analysis.Roofline(
        arch=arch, shape=kind, mesh="1", chips=1,
        flops_per_device=census.flops, flops_f32_per_device=census.flops_f32,
        bytes_per_device=census.bytes,
        collective_bytes_per_device=None).finalize()
    got = {"arch": arch, "step": kind, "census_s": meta_s,
           "kernel_calls": census.kernel_calls, "launches": launches,
           "aten_flops": census.aten_flops, "card_aten_flops": aten_flops,
           "peak_temp_bytes": census.peak_temp_bytes,
           "card_peak_bytes": peak,
           "peak_gap": (census.peak_temp_bytes - peak) / peak,
           "census_bytes": census.bytes, "census_flops": census.flops,
           "bound_ms": 1e3 * max(roof.compute_s, roof.memory_s),
           "bound_by": roof.bottleneck, "wall_ms": wall * 1e3}
    require(census.kernel_calls == launches,
            f"dry run ({arch} {kind}): census kernels "
            f"{census.kernel_calls} != LAUNCH_COUNTS {launches}")
    require(census.aten_flops == aten_flops,
            f"dry run ({arch} {kind}): census aten FLOPs "
            f"{census.aten_flops} != FlopCounterMode's {aten_flops}")
    require(abs(got["peak_gap"]) <= DRY_MEM_TOL,
            f"dry run ({arch} {kind}): census peak {census.peak_temp_bytes}"
            f" against the card's {peak} ({got['peak_gap']:+.3f})")
    return got


def run_lm_launcher(arch="qwen2-0.5b", seq=128):
    """``python -m repro_torch.launch.train lm --arch ARCH --steps 3
    --batch 2 --seq SEQ`` in this process, as a user calls it (full
    width, the card): it must exit 0 and print a finite final loss."""
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["lm", "--arch", arch, "--steps", "3",
                         "--batch", "2", "--seq", str(seq)])
    lines = out.getvalue().strip().splitlines()
    final = lines[-1]
    require(rc == 0 and final.startswith("steps/sec") and
            math.isfinite(float(final.split()[-1])),
            f"lm launcher: rc {rc}, {lines}")
    return lines


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


# --------------------------------------------------------------------------- #
# phase 15: the linters on the card
# --------------------------------------------------------------------------- #

HLOLINT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "torch_hlolint_fixtures",
                                "fixtures.py")


def run_linters(dev):
    """Every hlolint contract on ``dev`` under the sync debug mode "error"
    (``checks.run_contract``), the coverage scan, the fixture corpus's
    host-read entry, and tracelint over ``src/repro_torch``. Raises on any
    finding, on launches per dispatch that differ from the contract's or
    the meta census's, on a host read the card side lets through, and on
    a sync debug mode left changed. -> (one row a contract, the phase's
    launches: every count from a reset before each contract to its
    end, its build and warm-up included)."""
    import torch
    from repro_torch.analysis.hlolint import checks, cli as hcli, coverage
    from repro_torch.analysis.hlolint import entrypoints
    from repro_torch.analysis.tracelint import cli as tcli
    from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    root = os.path.dirname(os.path.abspath(__file__))
    mode = torch.cuda.get_sync_debug_mode()
    rows, launches = [], {}
    contracts = entrypoints.collect_contracts()
    for c in contracts:
        reset_launch_counts()
        t = time.perf_counter()
        found, report = checks.run_contract(c, entrypoints.BUILDERS[c.name],
                                            dev)
        secs = time.perf_counter() - t
        require(not found, f"hlolint {c.name} on the card: " +
                "; ".join(f.format() for f in found))
        require(report.card_launches == report.expected
                == report.meta_calls,
                f"hlolint {c.name}: LAUNCH_COUNTS {report.card_launches}, "
                f"contract {report.expected}, meta {report.meta_calls}")
        for k, v in LAUNCH_COUNTS.items():
            launches[k] = launches.get(k, 0) + v
        rows.append({"contract": c.name, "findings": 0,
                     "launch_counts_per_dispatch": report.card_launches,
                     "contract_per_dispatch": {
                         k: f"{c.launches[k]}={v}"
                         for k, v in report.expected.items()},
                     "meta_census_per_dispatch": report.meta_calls,
                     "aten_ops_per_dispatch": report.ops,
                     "dispatches": report.dispatches,
                     "moves_between_groups": report.moves,
                     "seconds": round(secs, 2)})
    cov = coverage.scan_tree(os.path.join(root, "src", "repro_torch"),
                             [c.name for c in contracts])
    require(not cov, "hlolint coverage: " + "; ".join(
        f.format() for f in cov))
    # the card side of the host-read family fires
    fixtures = hcli._load_fixture_module(HLOLINT_FIXTURES)
    bad = next(c for c in fixtures.HLOLINT_CONTRACTS
               if c.name == "bad_host_read")
    found, _ = checks.run_contract(bad, fixtures.BUILDERS[bad.name], dev)
    caught = [f.msg for f in found if f.rule == "host-read"]
    require(caught and any("sync debug mode" in m for m in caught),
            f"the host-read fixture was not caught on the card: {found}")
    rows.append({"fixture": "bad_host_read", "caught": caught})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main([os.path.join(root, "src", "repro_torch"),
                        "--baseline", os.path.join(
                            root, "tracelint-torch-baseline.txt")])
    require(rc == 0, f"tracelint on src/repro_torch: rc {rc}\n"
            + out.getvalue())
    rows.append({"tracelint": out.getvalue().strip().splitlines()[-1]})
    require(torch.cuda.get_sync_debug_mode() == mode,
            f"sync debug mode {torch.cuda.get_sync_debug_mode()} after "
            f"the phase, {mode} before")
    return rows, launches


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_ops as rops

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    repro_torch.exact_float32(dev)
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

    # the multi-device megastep on the one-card stand-in mesh
    t_mesh = time.perf_counter()
    groups = check_sharded_ops(dev)
    print(f"sharded wrappers (G {groups}, cuda:0 repeated) bitwise equal to "
          f"the single-device kernels on the whole pool", flush=True)
    for label, *path in MESH_PATHS:
        stats, counts = run_mesh_path(rops, label, *path)
        add_launches(counts)
        print(f"mesh path ({label}, one-card stand-in): within rtol "
              f"{MESH_RTOL} atol {MESH_ATOL} of the single-device twin; " +
              json.dumps({**stats, "launches": counts, "card": card}),
              flush=True)
    stats, counts = run_mesh_sanitized(rops)
    add_launches(counts)
    print("sanitize (mesh, SAC uniform, ac 2x2, sync debug mode \"error\"): "
          + json.dumps({**stats, "launches": counts, "card": card}),
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as mroot:
        stats, counts = run_resume_path(rops, mroot, 4, 8,
                                        mesh_shape=(2, 2))
    add_launches(counts)
    print("resume (uniform, ac 2x2, preempted at round 8, resumed): bitwise "
          "equal to the uninterrupted run on the mesh; " + json.dumps(
              {**stats, "launches": counts, "card": card}), flush=True)
    report, wall, spec, msg = run_example()
    print("example (train_sac_pendulum --seconds 3 --no-adapt): " +
          json.dumps({**report, "wall_s": wall, "card": card}), flush=True)
    print(f"example --mesh {spec} on {torch.cuda.device_count()} card(s): "
          f"refused, exit non-zero ({msg})", flush=True)
    for arm in ("one device", "ac 2x2", "ac 2x2", "one device"):
        kw = dict(eval_every_rounds=10**9)
        if arm != "one device":
            kw.update(mesh=card_mesh(2, 2), placement="ac")
        rates = timed_train(1.5, **kw)
        print(f"update_hz (SAC uniform, {arm}, one-card stand-in, 1.5 s): "
              f"{rates['update_hz']} ({card}); " + json.dumps(rates),
              flush=True)
    print(f"mesh paths: {time.perf_counter() - t_mesh:.1f} s", flush=True)

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
    for arch in SCAN_SHAPES:
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
        rel, tol, _ = check_serving_device_vs_cpu(dev, arch, layers, P,
                                                  dtype)
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

    # the MoE, enc-dec and VLM families and qwen2.5-32b
    t_fam = time.perf_counter()
    torch.cuda.empty_cache()
    worst_fa, worst_dec, rows = check_new_attention(dev)
    errs["flash_attention"] = max(errs["flash_attention"], worst_fa)
    errs["decode_attention"] = max(errs["decode_attention"], worst_dec)
    for row in rows:
        print(f"{row['kernel']} ({row['shape']}): " + json.dumps(
            {**row, "card": card}), flush=True)
    for arch, P in (("mixtral-8x7b", 80), ("kimi-k2-1t-a32b", 40),
                    ("whisper-medium", 40), ("paligemma-3b", 40)):
        for dtype in ("float32", "bfloat16"):
            rel, tol, flips = check_serving_device_vs_cpu(dev, arch, 2, P,
                                                          dtype)
            print(f"serving on cuda vs cpu (reduced {arch}, 2 layers, "
                  f"{dtype}, {P}-token prompts, prefill + 8 decode steps): "
                  f"{'tokens equal, ' if dtype == 'float32' else ''}logits "
                  f"max diff {rel:.3g} of the largest (limit {tol})" +
                  ("" if flips is None else
                   f" with the CPU's routing replayed; free run "
                   f"{flips['free_gap']:.3g}, (layer, token) routes flipped "
                   f"{flips['routes']}, gate values a bf16 step apart "
                   f"{flips['gates']}"), flush=True)
    for arch, (layers, param_dtype) in NEW_SERVE_RUNS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats, counts = run_serving_main_path(dev, arch, layers, param_dtype)
        add_launches(counts)
        print(f"serving main path ({arch}): " +
              json.dumps({**stats, "card": card}), flush=True)
        for k in ("tokens_per_s", "prefill_ms", "decode_step_ms",
                  "peak_mem_gb"):
            print(f"serving {arch} {k} {stats[k]} ({card})", flush=True)
    torch.cuda.empty_cache()
    lines, wall = run_serve_example()
    print(f"example (serve_decode --arch mixtral-8x7b, {wall:.1f} s): " +
          " | ".join(lines[:4]), flush=True)
    print(f"new families: {time.perf_counter() - t_fam:.1f} s", flush=True)

    # LM training of the attention families
    t_train = time.perf_counter()
    torch.cuda.empty_cache()
    bwd_errs, bwd_rel, rows = check_backward_kernels(dev)
    for row in rows:
        print(f"{row['kernel']} ({row['shape']}, {row['dtype']}): " +
              json.dumps(row), flush=True)
    print("backward kernels' largest gap, of the largest gradient value, "
          "and the forward's largest LSE gap: " + json.dumps(bwd_rel) +
          f" (limits {GRAD_TOL}, LSE {LSE_TOL})", flush=True)
    errs.update(bwd_errs)
    bwd_timing = time_backward_kernels(dev)
    for name, t in bwd_timing.items():
        print(f"{name}: max_abs_err {errs[name]} " + " ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()) + f" ({card})", flush=True)
    timing.update(bwd_timing)
    torch.cuda.empty_cache()
    stats, counts = run_train_main_path(dev)
    add_launches(counts)
    for label, st in stats.items():
        print(f"train main path ({TRAIN_ARCH}, {label}): " +
              json.dumps({**st, "card": card}), flush=True)
        for k in ("step_ms", "tokens_per_s", "peak_mem_gb", "first_loss",
                  "last_loss"):
            print(f"train {TRAIN_ARCH} ({label}) {k} {st[k]} ({card})",
                  flush=True)
    for arch, seq, layers in TRAIN_CHECKS:
        got = check_training_device_vs_cpu(dev, arch, seq, layers)
        print(f"train step on cuda vs cpu (reduced {arch}, {layers} layers,"
              f" float32, {seq} tokens): " + json.dumps(got), flush=True)
    torch.cuda.empty_cache()
    print("sanitized train step (qwen2-0.5b, sync debug mode \"error\"): " +
          json.dumps({**run_train_sanitized(dev), "card": card}), flush=True)
    torch.cuda.empty_cache()
    lines = run_lm_launcher()
    print("launcher (lm --arch qwen2-0.5b --steps 3 --batch 2 --seq 128): "
          + " | ".join(lines), flush=True)
    print(f"LM training: {time.perf_counter() - t_train:.1f} s", flush=True)

    # SSM and hybrid training: the scan's backward kernel, then the paths
    t_ssm = time.perf_counter()
    torch.cuda.empty_cache()
    errs["ssd_scan_bwd"], scan_rel, rows = check_ssd_scan_bwd(dev)
    for row in rows:
        print(f"ssd_scan_bwd ({row['shape']}, {row['dtype']}): " +
              json.dumps(row), flush=True)
    print("ssd_scan_bwd's largest gap, of the largest gradient value: " +
          json.dumps(scan_rel) + f" (limits {GRAD_TOL})", flush=True)
    timing["ssd_scan_bwd"] = time_ssd_scan_bwd(dev)
    print(f"ssd_scan_bwd: max_abs_err {errs['ssd_scan_bwd']} " + " ".join(
        f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in timing["ssd_scan_bwd"].items()) + f" ({card})",
        flush=True)
    for arch, steps in SSM_TRAIN_RUNS:
        torch.cuda.empty_cache()
        stats, counts = run_train_main_path(dev, arch, steps,
                                            SSM_TRAIN_LAUNCHES[arch])
        add_launches(counts)
        for label, st in stats.items():
            print(f"train main path ({arch}, {label}): " +
                  json.dumps({**st, "card": card}), flush=True)
            for k in ("step_ms", "tokens_per_s", "peak_mem_gb",
                      "first_loss", "last_loss"):
                print(f"train {arch} ({label}) {k} {st[k]} ({card})",
                      flush=True)
    torch.cuda.empty_cache()
    print("sanitized train step (mamba2-130m, sync debug mode \"error\"): "
          + json.dumps({**run_train_sanitized(dev, "mamba2-130m"),
                        "card": card}), flush=True)
    torch.cuda.empty_cache()
    lines = run_lm_launcher("mamba2-130m", 256)
    print("launcher (lm --arch mamba2-130m --steps 3 --batch 2 --seq 256): "
          + " | ".join(lines), flush=True)
    print(f"SSM training: {time.perf_counter() - t_ssm:.1f} s", flush=True)

    # the RL towers on LM backbones
    t_arch = time.perf_counter()
    torch.cuda.empty_cache()
    for arch, seq, layers in ARCH_RL_CHECKS:
        gaps = check_arch_rl_device_vs_cpu(dev, arch, seq, layers)
        print(f"arch RL checks (reduced {arch}, {layers} layers, float32, "
              f"{seq} tokens): both losses' gradients on cuda vs cpu within "
              f"{ARCH_RL_TOL} of each leaf's largest: " + json.dumps(gaps),
              flush=True)
    gaps = check_example_steps_device_vs_cpu(dev)
    print("arch RL example steps on cuda vs cpu (llm_rl, 3 steps from the "
          "same towers and draws): " + json.dumps(gaps), flush=True)
    lines, counts, wall, result = run_arch_rl_example(dev)
    add_launches(counts)
    print(f"arch RL example (llm_rl, {wall:.1f} s): " + " | ".join(lines) +
          "; " + json.dumps({**result, "launches": counts, "card": card}),
          flush=True)
    print(f"arch RL example: its check holds on the card (the warm-up "
          f"critic loss {result['warmup_first']:.4f} over the first "
          f"{result['span']} steps, {result['warmup_last']:.4f} over the "
          f"last); reward gain {result['final'] - result['reward0']:+.4f}, "
          f"not checked (float32 rounding decides where tanh saturates: "
          f"PERF.md)", flush=True)
    stats, counts = run_arch_rl_update(dev)
    add_launches(counts)
    print(f"arch RL update ({ARCH_RL_ARCH} full width, batch {ARCH_RL_B}, "
          f"seq {ARCH_RL_S}, act_dim {ARCH_RL_ACT}): " +
          json.dumps({**stats, "card": card}), flush=True)
    for k in ("mean_update_ms", "tokens_an_update", "tokens_per_s",
              "peak_mem_gb", "model_flops_share_of_989_tflops"):
        print(f"arch RL update {ARCH_RL_ARCH} {k} {stats[k]} ({card})",
              flush=True)
    cfg = granite_config()
    stats, counts = run_arch_rl_update(dev, cfg)
    add_launches(counts)
    print(f"arch RL update ({GRANITE_ARCH}, one period: {cfg.num_layers} "
          f"layers at full width, batch {ARCH_RL_B}, seq {ARCH_RL_S}, "
          f"act_dim {ARCH_RL_ACT}): " +
          json.dumps({**stats, "card": card}), flush=True)
    for k in ("mean_update_ms", "tokens_per_s", "peak_mem_gb"):
        print(f"arch RL update {GRANITE_ARCH} {k} {stats[k]} ({card})",
              flush=True)
    print(f"arch RL: {time.perf_counter() - t_arch:.1f} s", flush=True)

    # the dry run's census on the meta device against the card
    t_dry = time.perf_counter()
    for arch, kind in DRY_STEPS:
        got = check_dry_vs_card(dev, arch, kind)
        print(f"dry run vs card ({arch} {kind}): kernel calls equal "
              f"LAUNCH_COUNTS, aten FLOPs equal FlopCounterMode's, peak "
              f"{got['peak_gap']:+.4f} of the card's (limit "
              f"{DRY_MEM_TOL}); bound {got['bound_ms']:.3f} ms "
              f"({got['bound_by']}) against {got['wall_ms']:.3f} ms "
              f"measured ({card}); " + json.dumps(got), flush=True)
    print(f"dry run: {time.perf_counter() - t_dry:.1f} s", flush=True)

    # the linters: every hlolint contract on the card under the sync
    # debug mode "error", the host-read fixture, tracelint
    t_lint = time.perf_counter()
    rows, counts = run_linters(dev)
    add_launches(counts)
    for row in rows:
        print("linters: " + json.dumps({**row, "card": card}), flush=True)
    print(f"linters: {time.perf_counter() - t_lint:.1f} s ({card})",
          flush=True)

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
               "ring_gather_rowloop": ("ring_ops.cu", "replay_ops.py:644"),
               # the TPU kernels had no backward: the forward's wrapper
               "rmsnorm_bwd": ("rmsnorm.cu", "rmsnorm.py:29"),
               "flash_attention_bwd": ("flash_attention.cu",
                                       "flash_attention.py:77"),
               "ssd_scan_bwd": ("ssd_scan_bwd.cu", "ssd_scan.py:76"),
               # no TPU kernel: the JAX package's jnp rotation
               "rope": ("rope.cu", "../models/layers.py:63 apply_rope"),
               "rope_bwd": ("rope.cu", "../models/layers.py:63 apply_rope")}
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + src,
                "replaces": os.path.normpath("src/repro/kernels/" + tpu),
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
