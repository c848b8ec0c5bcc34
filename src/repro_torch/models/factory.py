"""Model factory: init / prefill / decode for the families the port serves.

Counterpart of ``repro/models/factory.py`` for the dense, ssm (mamba2)
and hybrid (zamba2: mamba2 core layers and one shared-weight attention
block run before every ``hybrid_attn_every`` of them) families:

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

from repro_torch._tree import stack_trees, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_init

_NOT_PORTED = {
    "moe": "the other LM families (MoE)",
    "encdec": "the other LM families (enc-dec)",
    "vlm": "the other LM families (VLM)",
}


def _layer_kind(cfg: ModelConfig) -> str:
    kind = {"dense": "dense", "ssm": "ssm", "hybrid": "ssm"}.get(cfg.family)
    if kind is None:
        item = _NOT_PORTED.get(cfg.family, "its family")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md queue 1, {item}")
    return kind


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
    if cfg.family == "hybrid":
        p["shared_attn"] = tf.init_layer(gen, cfg, kind="dense", dtype=dtype,
                                         device=device)
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                               device=device)
    return p


# Kept in float32: the norm weights (the kernel's float32 weight), and the
# SSM's decay parameters, which the reference uses in float32 arithmetic
# (``dt_bias``, ``A_log``; ``D_skip`` it casts at its use, as the port).
_FLOAT32 = ("ln1", "ln2", "ln_f", "norm_w", "A_log", "dt_bias")


def cast_params(params, dtype: torch.dtype):
    """Every weight cast to the compute dtype once, the norms and the SSM
    decay parameters kept in float32: the same numbers as the reference's
    cast at each use (``.astype(dtype)``), without repeating the cast
    every step."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v if k in _FLOAT32 else cast(v))
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


def _hybrid_groups(cfg: ModelConfig):
    """The hybrid's (start, end) core-layer slices; the shared attention
    block runs before each. The last may be shorter."""
    k = cfg.hybrid_attn_every
    return [(s, min(s + k, cfg.num_layers))
            for s in range(0, cfg.num_layers, k)]


def _slice_layers(stacked, s: int, e: int):
    """Layers [s, e) of a stacked tree, as views."""
    return tree_map(lambda a: a[s:e], stacked)


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    kind = _layer_kind(cfg)
    if cfg.family == "hybrid":
        core = tf.init_layer_cache(cfg, cfg.num_layers, batch, seq_len,
                                   kind="ssm", dtype=dtype, device=device)
        shape = (len(_hybrid_groups(cfg)), batch,
                 attn_lib.cache_len_for(cfg, seq_len), cfg.num_kv_heads,
                 cfg.head_dim)
        return {"core": core,
                "shared": {"k": torch.zeros(shape, dtype=dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=device)}}
    return tf.init_layer_cache(cfg, cfg.num_layers, batch, seq_len,
                               kind=kind, dtype=dtype, device=device)


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
    if cfg.family == "hybrid":
        core, shared = [], []
        for s, e in _hybrid_groups(cfg):
            x, sc = tf.layer_prefill(params["shared_attn"], x, cfg,
                                     kind="dense", positions=pos,
                                     dtype=dtype, ring_len=ring, seq_len=S)
            shared.append(sc)
            x, cc = tf.stack_prefill(_slice_layers(params["layers"], s, e),
                                     x, cfg, kind="ssm", positions=pos,
                                     dtype=dtype, ring_len=ring, seq_len=S)
            core.append(cc)
        cache = {"core": {k: torch.cat([c[k] for c in core])
                          for k in core[0]},
                 "shared": stack_trees(shared)}
    else:
        x, cache = tf.stack_prefill(params["layers"], x, cfg, kind=kind,
                                    positions=pos, dtype=dtype,
                                    ring_len=ring, seq_len=S)
    return cache, _logits(params, x[:, -1:].contiguous(), cfg, dtype)


def decode_step(params, token: torch.Tensor, cache, cache_pos: torch.Tensor,
                cfg: ModelConfig, *, dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token: (B,1) int; cache_pos: int32 scalar tensor on
    the model's device, the absolute position of this token. The cache is
    updated in place and returned."""
    kind = _layer_kind(cfg)
    x = _embed(params, token, cfg, dtype)
    if cfg.family == "hybrid":
        for gi, (s, e) in enumerate(_hybrid_groups(cfg)):
            sc = {"k": cache["shared"]["k"][gi],
                  "v": cache["shared"]["v"][gi]}
            x, _ = tf.layer_decode(params["shared_attn"], x, sc, cache_pos,
                                   cfg, kind="dense", dtype=dtype)
            x, _ = tf.stack_decode(_slice_layers(params["layers"], s, e), x,
                                   _slice_layers(cache["core"], s, e),
                                   cache_pos, cfg, kind="ssm", dtype=dtype)
    else:
        x, cache = tf.stack_decode(params["layers"], x, cache, cache_pos,
                                   cfg, kind=kind, dtype=dtype)
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


def _ssm_params(cfg: ModelConfig) -> int:
    d_inner, H, conv_ch, d_in_proj = ssm_lib.ssm_dims(cfg)
    return (cfg.d_model * d_in_proj + cfg.ssm.conv_dim * conv_ch + conv_ch
            + 3 * H + d_inner + d_inner * cfg.d_model)


def count_params_analytic(cfg: ModelConfig) -> int:
    kind = _layer_kind(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    total = V * D + D
    if not cfg.tie_embeddings:
        total += V * D
    dense = _attn_params(cfg) + 2 * D + 3 * D * cfg.d_ff
    if kind == "dense":
        return total + cfg.num_layers * dense
    total += cfg.num_layers * (_ssm_params(cfg) + D)
    if cfg.family == "hybrid":
        total += dense
    return total
