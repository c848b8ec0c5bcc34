"""GQA attention for prefill (causal, with a prefix, non-causal, and
cross attention over an encoder memory) and for one-token decode against
a KV cache (self attention with the cache write, or cross attention over
the memory's cache).

Counterpart of ``repro/models/attention.py``. The reference chose between
a jnp path and its Pallas kernels (``use_pallas``; its VLM prefill, with
a ``prefix_len``, always took the jnp path); the port always goes through
``kernels.ops``: the hand-written kernels on a CUDA tensor, their plain
versions on a CPU tensor, ``prefix_len`` included. Heads stay grouped
(KV, G), so repeated KV is never materialised. The kernels scale the
scores by 1/sqrt(head_dim); a config with an ``attention_multiplier``
(granite's softmax scale) has q multiplied by ``attention_multiplier *
sqrt(head_dim)`` first (0.125 for granite: a power of two, exact in
bf16).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=None):
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (h * hd, d), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        dev = p["wq"].device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def _project_q(p, x: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype
               ) -> torch.Tensor:
    q = x @ p["wq"].to(dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
    scale = getattr(cfg, "attention_multiplier", None)
    if scale is not None:
        q = q * (scale * math.sqrt(cfg.head_dim))
    return q.reshape(x.shape[:2] + (cfg.num_heads, cfg.head_dim))


def project_kv(p, memory: torch.Tensor, cfg: ModelConfig,
               dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project a sequence (an encoder memory, for cross-attention
    caching) to (K, V): (B, S, KV, hd) each."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    B, S = memory.shape[:2]
    k = memory @ p["wk"].to(dtype)
    v = memory @ p["wv"].to(dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return k.reshape(B, S, kv, hd), v.reshape(B, S, kv, hd)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True,
              window: Optional[int] = None, prefix_len: Optional[int] = None,
              x_kv: Optional[torch.Tensor] = None, rope: bool = True,
              dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill, encoder, cross) through the flash
    kernel.

    x: (B, Sq, D); x_kv: the source of K and V (an encoder memory for
    cross attention), x when not given; positions: (Sq,) positions of the
    q tokens. Under ``causal``, keys below ``prefix_len`` are visible to
    every query. Returns (out, (k, v)): the post-rope k and v fill the
    cache (for cross attention, the memory's cache).
    """
    q = _project_q(p, x, cfg, dtype)
    k, v = project_kv(p, x if x_kv is None else x_kv, cfg, dtype)
    if rope and cfg.use_rope:
        q, k = kops.rope(q, k, positions,
                         torch.arange(k.shape[1], device=k.device),
                         cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)
    out = out.reshape(out.shape[:2] + (-1,)) @ p["wo"].to(dtype)
    return out, (k, v)


def to_ring(k: torch.Tensor, seq_len: int, ring_len: int) -> torch.Tensor:
    """Pack the last ``ring_len`` tokens of (B,S,KV,hd) into ring layout
    where token t sits at slot t % ring_len (decode continues seamlessly)."""
    tail = k[:, -ring_len:]
    if ring_len == k.shape[1] and seq_len == ring_len:
        return tail
    return torch.roll(tail, shifts=seq_len % ring_len, dims=1)


def decode_attention(p, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     rope: bool = True, dtype=torch.bfloat16,
                     cross: bool = False,
                     memory_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache.

    x: (B, 1, D). cache_k/v: (B, S_cache, KV, hd). cache_pos: int32
    scalar tensor on x's device, the number of tokens already in the
    cache (the write slot, modulo the ring for a sliding window). The new
    token's k and v are written into the caches in place (the analogue of
    the reference's donated cache), then the decode kernel reads the
    valid slots; nothing here reads a tensor back to the host.

    ``cross``: the caches hold an encoder memory's K and V; only q is
    projected, nothing is written, and the slots below ``memory_len`` (an
    int32 scalar tensor on x's device; the whole cache when not given)
    attend.
    Returns (out, cache_k, cache_v).
    """
    S_cache = cache_k.shape[1]
    q = _project_q(p, x, cfg, dtype)
    pos = cache_pos.reshape(1)
    k = v = None
    if not cross:
        k, v = project_kv(p, x, cfg, dtype)
    if rope and cfg.use_rope:
        q, k = kops.rope(q, k, pos, None if k is None else pos,
                         cfg.rope_theta)
    if cross:
        valid_len = memory_len if memory_len is not None else torch.full(
            (), S_cache, dtype=torch.int32, device=x.device)
    else:
        slot = cache_pos % S_cache if window is not None else cache_pos
        slot = slot.reshape(1).long()
        cache_k.index_copy_(1, slot, k)
        cache_v.index_copy_(1, slot, v)
        valid_len = torch.clamp(cache_pos + 1, max=S_cache).to(torch.int32)
    out = kops.decode_attention(q[:, 0], cache_k, cache_v, valid_len)
    out = out.reshape(out.shape[0], 1, -1) @ p["wo"].to(dtype)
    return out, cache_k, cache_v


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: full context, or the SWA window if smaller."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len
