"""Model factory: init / prefill / decode for the families the port serves.

Counterpart of ``repro/models/factory.py``, dense family only:

  init_params(cfg, gen)                          -> param tree (f32)
  cast_params(params, dtype)                     -> the same, cast for compute
  init_cache(cfg, batch, seq_len)                -> stacked cache tree
  prefill(params, batch, cfg, seq_len)           -> (cache, last_logits)
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params_analytic(cfg)                     -> int

The other families raise ``NotImplementedError`` naming the ROADMAP item
that ports them; training (``loss_fn``, ``forward``) comes with the LM
training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init

_NOT_PORTED = {
    "ssm": "the SSM/hybrid serving path with ssd_scan",
    "hybrid": "the SSM/hybrid serving path with ssd_scan",
    "moe": "the other LM families (MoE)",
    "encdec": "the other LM families (enc-dec)",
    "vlm": "the other LM families (VLM)",
}


def _layer_kind(cfg: ModelConfig) -> str:
    if cfg.family != "dense":
        item = _NOT_PORTED.get(cfg.family, "its family")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md queue 1, {item}")
    return "dense"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``gen`` on ``device`` (the generator's device
    unless given; ``meta`` builds the shapes only)."""
    kind = _layer_kind(cfg)
    device = device or gen.device
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            device=device),
        "ln_f": tf.init_norm(cfg, device=device),
    }
    p["layers"] = tf.init_stack(gen, cfg, cfg.num_layers, kind=kind,
                                dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                               device=device)
    return p


_NORMS = ("ln1", "ln2", "ln_f")


def cast_params(params, dtype: torch.dtype):
    """Every weight cast to the compute dtype once, the norm weights kept
    in float32: the same numbers as the reference's cast at each use
    (``.astype(dtype)``), without repeating the cast every step."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v if k in _NORMS else cast(v))
                    for k, v in tree.items()}
        return tree.to(dtype)
    return cast(params)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           dtype: torch.dtype) -> torch.Tensor:
    return params["embed"][tokens].to(dtype)


def _logits(params, x: torch.Tensor, cfg: ModelConfig,
            dtype: torch.dtype) -> torch.Tensor:
    x = tf.apply_norm(params["ln_f"], x, cfg)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return x @ table.to(dtype).T


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    return tf.init_layer_cache(cfg, cfg.num_layers, batch, seq_len,
                               kind=_layer_kind(cfg), dtype=dtype,
                               device=device)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            seq_len: int, *, dtype=torch.bfloat16) -> Tuple[Any, torch.Tensor]:
    """Process a full prompt; returns (cache, logits of the final position).
    ``seq_len`` sizes the ring of a sliding-window cache."""
    kind = _layer_kind(cfg)
    tokens = batch["tokens"]
    ring = attn_lib.cache_len_for(cfg, seq_len)
    x = _embed(params, tokens, cfg, dtype)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    x, cache = tf.stack_prefill(params["layers"], x, cfg, kind=kind,
                                positions=pos, dtype=dtype, ring_len=ring,
                                seq_len=S)
    return cache, _logits(params, x[:, -1:].contiguous(), cfg, dtype)


def decode_step(params, token: torch.Tensor, cache, cache_pos: torch.Tensor,
                cfg: ModelConfig, *, dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token: (B,1) int; cache_pos: int32 scalar tensor on
    the model's device, the absolute position of this token. The cache is
    updated in place and returned."""
    kind = _layer_kind(cfg)
    x = _embed(params, token, cfg, dtype)
    x, cache = tf.stack_decode(params["layers"], x, cache, cache_pos, cfg,
                               kind=kind, dtype=dtype)
    return _logits(params, x, cfg, dtype), cache


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        n += h * hd + 2 * kv * hd
    return n


def count_params_analytic(cfg: ModelConfig) -> int:
    _layer_kind(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    total = V * D + D
    if not cfg.tie_embeddings:
        total += V * D
    per = _attn_params(cfg) + 2 * D + 3 * D * cfg.d_ff
    return total + cfg.num_layers * per
