"""Serving: prefill + batched greedy decode steps.

Counterpart of ``repro/serve/engine.py``. ``make_prefill_step`` /
``make_decode_step`` return plain functions:
  prefill_step(params, batch)                  -> (cache, logits_last)
  decode_step(params, token, cache, cache_pos) -> (logits, cache)

``greedy_generate`` is the serving path: prefill a batch of prompts, then
decode greedily with the KV cache (the SSM states for the ssm family, both
for the hybrid; ``_grow_cache`` pads only the attention caches). It runs
where its tensors are: the hand-written kernels on a CUDA device, their
plain versions on the CPU.
The decode position is a device int32 scalar advanced on the device, and
the cache is written in place, so no step reads a tensor back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import factory
from repro_torch.models.attention import cache_len_for


def dtype_of(name: str) -> torch.dtype:
    """A ``RunConfig`` dtype name -> torch dtype (the model kernels take
    float32 and bfloat16)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def make_prefill_step(rc: RunConfig, seq_len: int) -> Callable:
    cfg = rc.model
    cdtype = dtype_of(rc.compute_dtype)

    def prefill_step(params, batch):
        return factory.prefill(params, batch, cfg, seq_len, dtype=cdtype)

    return prefill_step


def make_decode_step(rc: RunConfig) -> Callable:
    cfg = rc.model
    cdtype = dtype_of(rc.compute_dtype)

    def decode_step(params, token, cache, cache_pos):
        return factory.decode_step(params, token, cache, cache_pos, cfg,
                                   dtype=cdtype)

    return decode_step


def _argmax_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32, the first maximum on a tie."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def greedy_generate(rc: RunConfig, params, batch: Dict[str, torch.Tensor],
                    prompt_len: int, num_tokens: int) -> torch.Tensor:
    """Prefill the prompt then greedily decode ``num_tokens`` tokens;
    returns (B, num_tokens) int32. As in the reference, the first token
    comes from the prefill and the last of the ``num_tokens`` decode
    steps' logits go unused."""
    cfg = rc.model
    total = prompt_len + num_tokens
    params = factory.cast_params(params, dtype_of(rc.compute_dtype))
    prefill_step = make_prefill_step(rc, total)
    decode_step = make_decode_step(rc)

    cache, logits = prefill_step(params, batch)
    # grow attention caches to the generation horizon
    cache = _grow_cache(cfg, cache, total)
    out = []
    tok = _argmax_token(logits)
    pos = torch.tensor(prompt_len, dtype=torch.int32, device=tok.device)
    for _ in range(num_tokens):
        out.append(tok)
        logits, cache = decode_step(params, tok, cache, pos)
        tok = _argmax_token(logits)
        pos = pos + 1
    return torch.cat(out, dim=1)


def _grow_cache(cfg: ModelConfig, cache, total_len: int):
    """Pad prefill-sized attention caches (dim after the batch dim) up to
    ``total_len`` ring slots (a no-op for a full sliding-window ring)."""
    target = cache_len_for(cfg, total_len)

    def grow(tree):
        out = {}
        for name, a in tree.items():
            if isinstance(a, dict):
                out[name] = grow(a)
            elif name in ("k", "v") and a.dim() == 5 and a.shape[2] < target:
                out[name] = F.pad(a, (0, 0, 0, 0, 0, target - a.shape[2]))
            else:
                out[name] = a
        return out

    return grow(cache)
