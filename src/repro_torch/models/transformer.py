"""Transformer blocks and layer stacks for every family.

Counterpart of ``repro/models/transformer.py``. Layer kinds:
  dense   pre-norm GQA attention + SwiGLU MLP (llama-style: the dense and
          VLM families, and the hybrid family's shared attention block)
  moe     attention + capacity-factor MoE (mixtral / kimi-k2)
  enc     whisper encoder: LayerNorm, non-causal self attention, GELU MLP
  dec     whisper decoder: causal self attention, cross attention over the
          encoder memory, GELU MLP; its cache adds the memory's ``xk`` /
          ``xv``
  ssm     pre-norm Mamba-2 SSD block (the ssm family, and the hybrid
          family's core layers)
  mamba   a Mamba-2 mixer followed by its own SwiGLU MLP, each pre-norm
          (the interleaved family's Mamba-2 layers; its attention layers
          are the dense kind)
The layout is the reference's: parameters and caches are stacked
``(L, ...)`` so every leaf maps one to one; where JAX scans over the
stack, the port loops over the layers in Python (``torch.unbind`` gives
each layer views of the stacked leaves, so the in-place cache writes land
in the stack). A stack's depth is its leading dimension, so a slice of
the layers (the hybrid's groups) runs as it is.

``stack_forward`` is the training forward: under ``remat`` each layer
runs inside ``torch.utils.checkpoint.checkpoint(..., use_reentrant=
False)``, the counterpart of the reference's ``jax.checkpoint`` of its
scan body, so the backward recomputes each layer's forward (its norms
and its attention or its scan once more) instead of keeping its
activations.

``interleaved_forward`` walks an ``InterleavedConfig``'s ``layer_types``
over one stack a kind (``{"mamba": ..., "attn": ...}``), each layer
checkpointed as ``stack_forward``'s. Where a config sets a
``residual_multiplier``, both residual branches of a layer are scaled by
it (one ``add`` with ``alpha``); a config without one adds them
unscaled.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import stack_trees, tree_leaves, unstack_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (gelu_mlp, init_gelu_mlp, init_mlp,
                                       layer_norm, mlp, rms_norm)

_KINDS = ("dense", "moe", "enc", "dec", "ssm", "mamba")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; known: {_KINDS}")


def _depth(stacked) -> int:
    """Layers in a stacked tree: the leading dimension of its leaves."""
    return tree_leaves(stacked)[0].shape[0]


def _use_ln(cfg: ModelConfig) -> bool:
    return cfg.family == "encdec"     # whisper uses LayerNorm w/ bias


def _residual(x: torch.Tensor, h: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """x + h, or x + residual_multiplier * h where the config sets one."""
    r = getattr(cfg, "residual_multiplier", None)
    return x + h if r is None else torch.add(x, h, alpha=r)


def init_norm(cfg: ModelConfig, device=None):
    """RMSNorm's weight, or LayerNorm's weight and bias (whisper)."""
    p = {"w": torch.ones((cfg.d_model,), device=device)}
    if _use_ln(cfg):
        p["b"] = torch.zeros((cfg.d_model,), device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """LayerNorm where the norm has a bias (plain PyTorch: the reference
    has no kernel for it), else the rmsnorm kernel."""
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ModelConfig, *, kind: str,
               dtype=torch.float32, device=None):
    _check_kind(kind)
    device = device or gen.device
    if kind in ("ssm", "mamba"):
        p = {"ln1": init_norm(cfg, device=device),
             "ssm": ssm_lib.init_ssm(gen, cfg, dtype=dtype, device=device)}
        if kind == "mamba":
            p["ln2"] = init_norm(cfg, device=device)
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                device=device)
        return p
    p = {"ln1": init_norm(cfg, device=device),
         "attn": attn_lib.init_attention(gen, cfg, dtype=dtype,
                                         device=device),
         "ln2": init_norm(cfg, device=device)}
    if kind == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            device=device)
    elif kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype=dtype, device=device)
    elif kind == "enc":
        p["mlp"] = init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                 device=device)
    else:                                                  # dec
        p["xattn"] = attn_lib.init_attention(gen, cfg, dtype=dtype,
                                             device=device)
        p["ln3"] = init_norm(cfg, device=device)
        p["mlp"] = init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                 device=device)
    return p


def init_stack(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
               kind: str, dtype=torch.float32, device=None):
    return stack_trees([init_layer(gen, cfg, kind=kind, dtype=dtype,
                                   device=device) for _ in range(n_layers)])


# ---------------------------------------------------------------------------
# full-sequence forward of the attention kinds
# ---------------------------------------------------------------------------

def _attn_layer(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                positions: torch.Tensor, prefix_len: Optional[int],
                memory: Optional[torch.Tensor], dtype):
    """One dense / moe / enc / dec layer over a whole sequence. Returns
    (x, the MoE's aux loss or None, self (k, v), cross (k, v) or None)."""
    aux = None
    causal = kind != "enc"
    h, kv = attn_lib.attention(
        p["attn"], apply_norm(p["ln1"], x, cfg), cfg, positions=positions,
        causal=causal, window=cfg.sliding_window if causal else None,
        prefix_len=prefix_len, dtype=dtype)
    x = _residual(x, h, cfg)
    if kind == "dec":
        # the cross attention's K and V are project_kv(memory): the
        # memory's cache
        h, xkv = attn_lib.attention(
            p["xattn"], apply_norm(p["ln2"], x, cfg), cfg,
            positions=positions, causal=False, x_kv=memory, rope=False,
            dtype=dtype)
        x = x + h
        x = x + gelu_mlp(p["mlp"], apply_norm(p["ln3"], x, cfg), dtype)
        return x, aux, kv, xkv
    y = apply_norm(p["ln2"], x, cfg)
    if kind == "moe":
        h, aux = moe_lib.moe_block(p["moe"], y, cfg, dtype=dtype)
    elif kind == "enc":
        h = gelu_mlp(p["mlp"], y, dtype)
    else:
        h = mlp(p["mlp"], y, dtype)
    return _residual(x, h, cfg), aux, kv, None


def layer_forward(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, prefix_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16,
                  ssm_state: Optional[torch.Tensor] = None):
    """One layer over a whole sequence (training). Returns (x, aux_loss,
    extra): extra is the ``ssm`` and ``mamba`` kinds' final state (the
    scan starting from ``ssm_state``, or zero), None for the attention
    kinds."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("ssm", "mamba"):
        h, extra = ssm_lib.ssm_block(p["ssm"], apply_norm(p["ln1"], x, cfg),
                                     cfg, dtype=dtype,
                                     initial_state=ssm_state)
        x = _residual(x, h, cfg)
        if kind == "mamba":
            x = _residual(x, mlp(p["mlp"], apply_norm(p["ln2"], x, cfg),
                                 dtype), cfg)
        return x, aux, extra
    x, moe_aux, _, _ = _attn_layer(p, x, cfg, kind=kind,
                                   positions=positions,
                                   prefix_len=prefix_len, memory=memory,
                                   dtype=dtype)
    return x, aux if moe_aux is None else moe_aux, None


def stack_forward(stacked, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, prefix_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16, remat: bool = True):
    """Loop over the layers (no cache). Under ``remat`` each layer is
    checkpointed: its activations are dropped and recomputed in the
    backward. An SSM layer's final state is dropped, as the reference's
    scan drops it. Returns (x, total aux loss)."""
    def body(layer_p, h):
        h, a, _ = layer_forward(layer_p, h, cfg, kind=kind,
                                positions=positions, prefix_len=prefix_len,
                                memory=memory, dtype=dtype)
        return h, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer_p in unstack_tree(stacked, _depth(stacked)):
        if remat:
            x, a = checkpoint(body, layer_p, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(layer_p, x)
        aux = aux + a
    return x, aux


def interleaved_forward(layers, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: torch.Tensor, dtype=torch.bfloat16,
                        remat: bool = True) -> torch.Tensor:
    """The interleaved family's layers in ``cfg.layer_types`` order: a
    ``"mamba"`` entry takes the next layer of ``layers["mamba"]`` (the
    ``mamba`` kind), an ``"attention"`` entry the next of
    ``layers["attn"]`` (the ``dense`` kind), each checkpointed under
    ``remat``. Returns x."""
    stacks = {k: iter(unstack_tree(v, _depth(v))) for k, v in layers.items()}
    for t in cfg.layer_types:
        kind, key = ("mamba", "mamba") if t == "mamba" else ("dense", "attn")

        def body(layer_p, h, kind=kind):
            return layer_forward(layer_p, h, cfg, kind=kind,
                                 positions=positions, dtype=dtype)[0]
        layer_p = next(stacks[key])
        if remat:
            x = checkpoint(body, layer_p, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(layer_p, x)
    return x


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also emits per-layer caches
# ---------------------------------------------------------------------------

def layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, prefix_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16, ring_len: int, seq_len: int):
    """Returns (x, layer_cache)."""
    _check_kind(kind)
    if kind == "ssm":
        h, cache = ssm_lib.ssm_block(p["ssm"], apply_norm(p["ln1"], x, cfg),
                                     cfg, dtype=dtype, return_cache=True)
        return x + h, cache
    x, _, (k, v), xkv = _attn_layer(p, x, cfg, kind=kind,
                                    positions=positions,
                                    prefix_len=prefix_len, memory=memory,
                                    dtype=dtype)
    cache = {"k": attn_lib.to_ring(k, seq_len, ring_len),
             "v": attn_lib.to_ring(v, seq_len, ring_len)}
    if xkv is not None:
        cache["xk"], cache["xv"] = xkv
    return x, cache


def stack_prefill(stacked, x: torch.Tensor, cfg: ModelConfig, *, kind: str,
                  positions: torch.Tensor, prefix_len: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None,
                  dtype=torch.bfloat16, ring_len: int, seq_len: int):
    """Loop over layers, emitting the stacked (L, ...) cache tree."""
    caches = []
    for layer_p in unstack_tree(stacked, _depth(stacked)):
        x, cache = layer_prefill(layer_p, x, cfg, kind=kind,
                                 positions=positions, prefix_len=prefix_len,
                                 memory=memory, dtype=dtype,
                                 ring_len=ring_len, seq_len=seq_len)
        caches.append(cache)
    return x, stack_trees(caches)


# ---------------------------------------------------------------------------
# per-layer decode (one token, cache)
# ---------------------------------------------------------------------------

def layer_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cache_pos: torch.Tensor, cfg: ModelConfig, *, kind: str,
                 memory_len: Optional[torch.Tensor] = None,
                 dtype=torch.bfloat16):
    """x: (B,1,D). cache: this layer's {"k", "v"} (and the memory's
    {"xk", "xv"} for dec) or {"ssm_state", "conv_state"} (ssm), written in
    place. ``memory_len``: dec's valid memory slots, an int32 scalar
    tensor on x's device. Returns (x, cache)."""
    _check_kind(kind)
    if kind == "ssm":
        h, cache = ssm_lib.ssm_decode_step(
            p["ssm"], apply_norm(p["ln1"], x, cfg), cache, cfg, dtype=dtype)
        return x + h, cache
    h, nk, nv = attn_lib.decode_attention(
        p["attn"], apply_norm(p["ln1"], x, cfg), cache["k"], cache["v"],
        cache_pos, cfg, window=cfg.sliding_window, dtype=dtype)
    x = x + h
    cache = dict(cache, k=nk, v=nv)
    if kind == "dec":
        h, _, _ = attn_lib.decode_attention(
            p["xattn"], apply_norm(p["ln2"], x, cfg), cache["xk"],
            cache["xv"], cache_pos, cfg, rope=False, dtype=dtype,
            cross=True, memory_len=memory_len)
        x = x + h
        return x + gelu_mlp(p["mlp"], apply_norm(p["ln3"], x, cfg),
                            dtype), cache
    y = apply_norm(p["ln2"], x, cfg)
    if kind == "moe":
        h, _ = moe_lib.moe_block(p["moe"], y, cfg, dtype=dtype)
    elif kind == "enc":
        h = gelu_mlp(p["mlp"], y, dtype)
    else:
        h = mlp(p["mlp"], y, dtype)
    return x + h, cache


def stack_decode(stacked, x: torch.Tensor, caches, cache_pos: torch.Tensor,
                 cfg: ModelConfig, *, kind: str,
                 memory_len: Optional[torch.Tensor] = None,
                 dtype=torch.bfloat16):
    """Loop over (layer params, layer cache); the stacked caches are
    updated in place. Returns (x, caches)."""
    n = _depth(stacked)
    for layer_p, layer_cache in zip(unstack_tree(stacked, n),
                                    unstack_tree(caches, n)):
        x, _ = layer_decode(layer_p, x, layer_cache, cache_pos, cfg,
                            kind=kind, memory_len=memory_len, dtype=dtype)
    return x, caches


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, n_layers: int, batch: int,
                     seq_len: int, *, kind: str, dtype=torch.bfloat16,
                     device=None, memory_len: int = 0):
    """Stacked (L, ...) cache tree for ``stack_decode``."""
    _check_kind(kind)
    if kind == "ssm":
        one = ssm_lib.init_ssm_cache(cfg, batch, dtype=dtype, device=device)
        return {k: torch.zeros((n_layers,) + a.shape, dtype=a.dtype,
                               device=a.device) for k, a in one.items()}
    S = attn_lib.cache_len_for(cfg, seq_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (n_layers, batch, S, kv, hd)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "dec":
        mem = (n_layers, batch, memory_len, kv, hd)
        c["xk"] = torch.zeros(mem, dtype=dtype, device=device)
        c["xv"] = torch.zeros(mem, dtype=dtype, device=device)
    return c
