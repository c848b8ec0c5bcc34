"""Serving launcher: prefill a batch of prompts, then batched greedy decode.

Runs on the CUDA card unless ``--device cpu`` is given; the device
decides between the hand-written kernels and their plain versions.
Weights are random, from ``--seed``; prompts (and whisper's frame or
paligemma's patch embeddings) from ``--seed + 1``. Every registered
architecture (``repro_torch.configs.ARCHS``) serves. ``--layers`` cuts
the depth at full width, for the models whose parameters do not fit one
card (mixtral-8x7b, kimi-k2-1t-a32b, qwen2.5-32b); ``--param-dtype
bfloat16`` draws the parameters in bf16 (the norms and the MoE router
stay float32), which kimi's one layer of 384 experts needs.

Example:
  python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 8 --prompt-len 1024 --gen 64
  python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced \\
      --device cpu --batch 2 --prompt-len 32 --gen 16
  python -m repro_torch.launch.serve --arch mamba2-130m \\
      --batch 8 --prompt-len 1024 --gen 64
  python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced \\
      --device cpu --batch 2 --prompt-len 32 --gen 16
  python -m repro_torch.launch.serve --arch whisper-medium \\
      --batch 8 --prompt-len 1024 --gen 64
  python -m repro_torch.launch.serve --arch paligemma-3b \\
      --batch 8 --prompt-len 1024 --gen 64
  python -m repro_torch.launch.serve --arch mixtral-8x7b --layers 4 \\
      --batch 8 --prompt-len 1024 --gen 64
  python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --layers 1 \\
      --param-dtype bfloat16 --batch 8 --prompt-len 1024 --gen 64

``--prompt-len`` counts text tokens: paligemma's 256 patch embeddings
(16 reduced) come before them, and whisper's encoder reads 1500 frames
(32 reduced).

The ssm and hybrid families scan the prompt in chunks of
min(chunk_size, prompt length), which must divide the prompt length
(256 at full width, 32 reduced): a prompt of at most one chunk, or a
multiple of it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--param-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch import card_line, resolve_device
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.factory import init_params
    from repro_torch.serve.engine import dtype_of, greedy_generate, prefix_len

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = InputShape("serve", seq_len=args.prompt_len + prefix_len(cfg),
                       global_batch=args.batch, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape)
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         dtype=dtype_of(args.param_dtype))
    batch = make_batch(cfg, shape,
                       torch.Generator(dev).manual_seed(args.seed + 1))

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = greedy_generate(rc, params, batch, args.prompt_len, args.gen)
    toks = toks.cpu()            # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(card_line(dev))
    print(toks[:, :12])
    return 0


if __name__ == "__main__":
    sys.exit(main())
