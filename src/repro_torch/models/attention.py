"""GQA attention for prefill and for one-token decode against a KV cache.

Counterpart of ``repro/models/attention.py`` for the families this port
serves (dense; no cross attention and no VLM prefix yet). The reference
chose between a jnp path and its Pallas kernels (``use_pallas``); the
port always goes through ``kernels.ops``: the hand-written kernels on a
CUDA tensor, their plain versions on a CPU tensor. Heads stay grouped
(KV, G), so repeated KV is never materialised.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init


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


def _project_qkv(p, x: torch.Tensor, x_kv: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(dtype)
    k = x_kv @ p["wk"].to(dtype)
    v = x_kv @ p["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    B, Sq = x.shape[:2]
    Sk = x_kv.shape[1]
    return (q.reshape(B, Sq, h, hd), k.reshape(B, Sk, kv, hd),
            v.reshape(B, Sk, kv, hd))


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: Optional[int] = None,
              dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self attention (prefill) through the flash
    kernel.

    x: (B, S, D); positions: (S,) positions of the tokens. Returns
    (out, (k, v)): the post-rope k and v fill the cache.
    """
    q, k, v = _project_qkv(p, x, x, cfg, dtype)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, torch.arange(k.shape[1], device=k.device),
                       cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=True, window=window)
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
                     dtype=torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a KV cache.

    x: (B, 1, D). cache_k/v: (B, S_cache, KV, hd). cache_pos: int32
    scalar tensor on x's device, the number of tokens already in the
    cache (the write slot, modulo the ring for a sliding window). The new
    token's k and v are written into the caches in place (the analogue of
    the reference's donated cache), then the decode kernel reads the
    valid slots; nothing here reads a tensor back to the host.
    Returns (out, cache_k, cache_v).
    """
    S_cache = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, x, cfg, dtype)
    if cfg.use_rope:
        pos = cache_pos.reshape(1)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
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
