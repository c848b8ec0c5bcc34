"""Serving: prefill + batched greedy decode steps.

Counterpart of ``repro/serve/engine.py``. ``make_prefill_step`` /
``make_decode_step`` return plain functions:
  prefill_step(params, batch)                  -> (cache, logits_last)
  decode_step(params, token, cache, cache_pos) -> (logits, cache)

``greedy_generate`` is the serving path: prefill a batch of prompts, then
decode greedily with the KV cache (the SSM states for the ssm family, both
for the hybrid, and the encoder memory's cross-attention cache for
enc-dec; ``_grow_cache`` pads only the self-attention caches). It runs
where its tensors are: the hand-written kernels on a CUDA device, their
plain versions on the CPU.

The VLM's patch prefix counts in the cache: the caches hold
``num_patch_tokens + prompt_len + num_tokens`` slots and decode starts at
position ``num_patch_tokens + prompt_len``. (The reference sizes them
from ``prompt_len + num_tokens`` alone, so its prefill keeps only the
last keys of the prefix and prompt, and its decode writes past the
cache; see ROADMAP.md, "Reference paths that are red".)
The decode position is a device int32 scalar advanced on the device, and
the cache is written in place, so no step reads a tensor back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.analysis.hlolint.contract import EntrypointContract
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import factory
from repro_torch.models.attention import cache_len_for
from repro_torch.train.trainer import dtype_of


# hlolint contract of a decode step at the probe's reduced dense arch: the
# KV cache written in place (a rebuilt cache would copy it every token), a
# rmsnorm a norm, and one rope and one decode attention a layer
HLOLINT_CONTRACTS = (
    EntrypointContract(
        name="serve_decode_step", module=__name__, inplace=True,
        state=("cache",), float_dtypes=("float32", "bfloat16"),
        launches={"rmsnorm": "2*layers+1", "rope": "layers",
                  "decode_attention": "layers"}),
)


def make_prefill_step(rc: RunConfig, seq_len: int) -> Callable:
    cfg = rc.model
    cdtype = dtype_of(rc.compute_dtype)

    def prefill_step(params, batch):
        return factory.prefill(params, batch, cfg, seq_len, dtype=cdtype)

    return prefill_step


# hlolint: entrypoint[serve_decode_step]
def make_decode_step(rc: RunConfig) -> Callable:
    """enc-dec: the memory's valid length is made on the device once, at
    the first step, and reused by every later one."""
    cfg = rc.model
    cdtype = dtype_of(rc.compute_dtype)
    memory_len = {}                          # device -> int32 scalar

    def decode_step(params, token, cache, cache_pos):
        kw = {}
        if cfg.family == "encdec":
            dev = cache_pos.device
            if dev not in memory_len:
                memory_len[dev] = torch.full((), cfg.encoder_seq,
                                             dtype=torch.int32, device=dev)
            kw["memory_len"] = memory_len[dev]
        return factory.decode_step(params, token, cache, cache_pos, cfg,
                                   dtype=cdtype, **kw)

    return decode_step


def _argmax_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32, the first maximum on a tie."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def greedy_generate(rc: RunConfig, params, batch: Dict[str, torch.Tensor],
                    prompt_len: int, num_tokens: int) -> torch.Tensor:
    """Prefill the prompt then greedily decode ``num_tokens`` tokens;
    returns (B, num_tokens) int32. As in the reference, the first token
    comes from the prefill and the last of the ``num_tokens`` decode
    steps' logits go unused. ``batch`` holds ``tokens`` (B, prompt_len),
    and ``frames`` (enc-dec) or ``patches`` (VLM)."""
    cfg = rc.model
    prefix = prefix_len(cfg)
    total = prefix + prompt_len + num_tokens
    params = factory.cast_params(params, dtype_of(rc.compute_dtype))
    prefill_step = make_prefill_step(rc, total)
    decode_step = make_decode_step(rc)

    cache, logits = prefill_step(params, batch)
    # grow attention caches to the generation horizon
    cache = _grow_cache(cfg, cache, total)
    out = []
    tok = _argmax_token(logits)
    pos = torch.tensor(prefix + prompt_len, dtype=torch.int32,
                       device=tok.device)
    for _ in range(num_tokens):
        out.append(tok)
        logits, cache = decode_step(params, tok, cache, pos)
        tok = _argmax_token(logits)
        pos = pos + 1
    return torch.cat(out, dim=1)


def prefix_len(cfg: ModelConfig) -> int:
    """Positions before the prompt: the VLM's patch tokens."""
    return cfg.num_patch_tokens if cfg.family == "vlm" else 0


def _grow_cache(cfg: ModelConfig, cache, total_len: int):
    """Pad prefill-sized self-attention caches (``k``/``v``: dim after the
    batch dim) up to ``total_len`` ring slots (a no-op for a full
    sliding-window ring); the memory's ``xk``/``xv`` stay as they are."""
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
