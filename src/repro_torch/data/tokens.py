"""Synthetic token / frame / patch batches.

Counterpart of ``repro/data/tokens.py``. Tokens, frame embeddings
(enc-dec) and patch embeddings (VLM) are drawn from an explicit
``torch.Generator`` on its device, in that order; JAX's threefry gives
other numbers from the same seed, so parity tests carry the reference's
batch across instead.
"""
from __future__ import annotations

from typing import Dict

import torch

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
