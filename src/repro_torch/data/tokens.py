"""Synthetic token / frame / patch batches.

Counterpart of ``repro/data/tokens.py``. Tokens, frame embeddings
(enc-dec) and patch embeddings (VLM) are drawn from an explicit
``torch.Generator`` on its device, in that order; JAX's threefry gives
other numbers from the same seed, so parity tests carry the reference's
batch across instead. ``batch_iterator`` is the reference's endless
stream: batch i from its own generator keyed by (seed, i), the
counterpart of ``fold_in(key, i)``, so a batch does not depend on the
ones drawn before it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig


def text_len(cfg: ModelConfig, shape_seq: int) -> int:
    """Token count for the given total sequence length (VLMs reserve the
    patch prefix inside the assigned seq_len)."""
    if cfg.family == "vlm":
        return shape_seq - cfg.num_patch_tokens
    return shape_seq


def make_batch(cfg: ModelConfig, shape: InputShape, gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """``shape.global_batch`` prompts of ``text_len`` int32 tokens, and
    float32 ``frames`` (B, encoder_seq, D) for enc-dec or ``patches``
    (B, num_patch_tokens, D) for the VLM."""
    B, dev = shape.global_batch, gen.device
    out = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, text_len(cfg, shape.seq_len)),
        generator=gen, device=dev, dtype=torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, device=dev)
    if cfg.family == "vlm":
        out["patches"] = torch.randn((B, cfg.num_patch_tokens, cfg.d_model),
                                     generator=gen, device=dev)
    return out


def batch_iterator(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                   batch: Optional[int] = None, seq: Optional[int] = None,
                   device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Endless ``make_batch`` batches on ``device`` (the card unless the
    caller asks for the CPU; ``batch`` and ``seq`` override the shape's),
    batch i drawn from a generator seeded by SeedSequence((seed, i))."""
    device = resolve_device(device)
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq or shape.seq_len)
    i = 0
    while True:
        s = np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)
        yield make_batch(cfg, shape, torch.Generator(
            device=device).manual_seed(int(s[0])))
        i += 1
