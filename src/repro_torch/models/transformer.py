"""Transformer blocks and layer stacks: the two layer kinds the port
serves.

Counterpart of ``repro/models/transformer.py`` for two kinds of layer:
  dense   pre-norm GQA attention + SwiGLU MLP (llama-style; also the
          hybrid family's shared attention block)
  ssm     pre-norm Mamba-2 SSD block (the ssm family, and the hybrid
          family's core layers)
The layout is the reference's: parameters and caches are stacked
``(L, ...)`` so every leaf maps one to one; where JAX scans over the
stack, the port loops over the layers in Python (``torch.unbind`` gives
each layer views of the stacked leaves, so the in-place cache writes land
in the stack). A stack's depth is its leading dimension, so a slice of
the layers (the hybrid's groups) runs as it is. The other kinds (MoE,
enc-dec) come with their slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._tree import stack_trees, tree_leaves, unstack_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, mlp, rms_norm

_KINDS = ("dense", "ssm")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP.md, queue 1)")


def _depth(stacked) -> int:
    """Layers in a stacked tree: the leading dimension of its leaves."""
    return tree_leaves(stacked)[0].shape[0]


def init_norm(cfg: ModelConfig, device=None):
    """RMSNorm's weight (the enc-dec family's LayerNorm comes with it)."""
    return {"w": torch.ones((cfg.d_model,), device=device)}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, *, kind: str,
               dtype=torch.float32, device=None):
    _check_kind(kind)
    device = device or gen.device
    if kind == "ssm":
        return {"ln1": init_norm(cfg, device=device),
                "ssm": ssm_lib.init_ssm(gen, cfg, dtype=dtype,
                                        device=device)}
    return {"ln1": init_norm(cfg, device=device),
            "attn": attn_lib.init_attention(gen, cfg, dtype=dtype,
                                            device=device),
            "ln2": init_norm(cfg, device=device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            device=device)}


def init_stack(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
               kind: str, dtype=torch.float32, device=None):
    return stack_trees([init_layer(gen, cfg, kind=kind, dtype=dtype,
                                   device=device) for _ in range(n_layers)])


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also emits per-layer caches
# ---------------------------------------------------------------------------

def layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, dtype=torch.bfloat16,
                  ring_len: int, seq_len: int):
    """Returns (x, layer_cache)."""
    _check_kind(kind)
    if kind == "ssm":
        h, cache = ssm_lib.ssm_block(p["ssm"], apply_norm(p["ln1"], x, cfg),
                                     cfg, dtype=dtype, return_cache=True)
        return x + h, cache
    h, (k, v) = attn_lib.attention(
        p["attn"], apply_norm(p["ln1"], x, cfg), cfg, positions=positions,
        window=cfg.sliding_window, dtype=dtype)
    x = x + h
    cache = {"k": attn_lib.to_ring(k, seq_len, ring_len),
             "v": attn_lib.to_ring(v, seq_len, ring_len)}
    y = apply_norm(p["ln2"], x, cfg)
    return x + mlp(p["mlp"], y, dtype), cache


def stack_prefill(stacked, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, dtype=torch.bfloat16,
                  ring_len: int, seq_len: int):
    """Loop over layers, emitting the stacked (L, ...) cache tree."""
    caches = []
    for layer_p in unstack_tree(stacked, _depth(stacked)):
        x, cache = layer_prefill(layer_p, x, cfg, kind=kind,
                                 positions=positions, dtype=dtype,
                                 ring_len=ring_len, seq_len=seq_len)
        caches.append(cache)
    return x, stack_trees(caches)


# ---------------------------------------------------------------------------
# per-layer decode (one token, cache)
# ---------------------------------------------------------------------------

def layer_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cache_pos: torch.Tensor, cfg: ModelConfig, *, kind: str,
                 dtype=torch.bfloat16):
    """x: (B,1,D). cache: this layer's {"k", "v"} (dense) or
    {"ssm_state", "conv_state"} (ssm), written in place. Returns
    (x, cache)."""
    _check_kind(kind)
    if kind == "ssm":
        h, cache = ssm_lib.ssm_decode_step(
            p["ssm"], apply_norm(p["ln1"], x, cfg), cache, cfg, dtype=dtype)
        return x + h, cache
    h, nk, nv = attn_lib.decode_attention(
        p["attn"], apply_norm(p["ln1"], x, cfg), cache["k"], cache["v"],
        cache_pos, cfg, window=cfg.sliding_window, dtype=dtype)
    x = x + h
    y = apply_norm(p["ln2"], x, cfg)
    return x + mlp(p["mlp"], y, dtype), dict(cache, k=nk, v=nv)


def stack_decode(stacked, x: torch.Tensor, caches, cache_pos: torch.Tensor,
                 cfg: ModelConfig, *, kind: str, dtype=torch.bfloat16):
    """Loop over (layer params, layer cache); the stacked caches are
    updated in place. Returns (x, caches)."""
    n = _depth(stacked)
    for layer_p, layer_cache in zip(unstack_tree(stacked, n),
                                    unstack_tree(caches, n)):
        x, _ = layer_decode(layer_p, x, layer_cache, cache_pos, cfg,
                            kind=kind, dtype=dtype)
    return x, caches


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, n_layers: int, batch: int,
                     seq_len: int, *, kind: str, dtype=torch.bfloat16,
                     device=None):
    """Stacked (L, ...) cache tree for ``stack_decode``."""
    _check_kind(kind)
    if kind == "ssm":
        one = ssm_lib.init_ssm_cache(cfg, batch, dtype=dtype, device=device)
        return {k: torch.zeros((n_layers,) + a.shape, dtype=a.dtype,
                               device=a.device) for k, a in one.items()}
    S = attn_lib.cache_len_for(cfg, seq_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (n_layers, batch, S, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
