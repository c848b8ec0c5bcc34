"""Synthetic token batches.

Counterpart of ``repro/data/tokens.py`` for the families the port serves
(dense, ssm and hybrid: tokens only). Tokens are drawn from an explicit
``torch.Generator`` on its device; JAX's threefry gives other tokens from
the same seed, so parity tests carry the reference's batch across instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def make_batch(cfg: ModelConfig, shape: InputShape, gen: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """``shape.global_batch`` prompts of ``shape.seq_len`` int32 tokens."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"batches for family {cfg.family!r} (frames, patches) are not "
            "ported yet (ROADMAP.md, queue 1)")
    return {"tokens": torch.randint(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
        generator=gen, device=gen.device, dtype=torch.int32)}
