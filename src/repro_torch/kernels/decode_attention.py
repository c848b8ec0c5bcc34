"""Decode attention: one query token per (b, h) against a KV cache whose
slots ``[0, valid_len)`` attend, GQA.

Counterpart of ``repro/kernels/decode_attention.py:decode_attention`` and
of its oracle ``repro/kernels/ref.py:decode_attention_ref``.
``decode_attention`` launches the CUDA kernels (``csrc/decode_attention.cu``:
a split-K pass and the combination of the splits, one call of the wrapper
and one count in ``LAUNCH_COUNTS``) and only those: a
tensor that is not on a CUDA device is refused. ``decode_attention_ref``
is the plain PyTorch version (``kernels.ops`` picks between the two by the
operand's device). Both compute in float32 and return q's dtype.

``valid_len`` is a device int32 scalar that the kernel reads itself
(clamped to the cache length), so a decode loop never waits on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand
from repro_torch.kernels._build import load_kernels
from repro_torch.kernels.flash_attention import NEG_INF


def _dims(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, d) and the "
                         f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} (B, S, KV, d)")
    B, H, d = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != d or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and the cache "
                         f"{tuple(k_cache.shape)} do not pair: H must be a "
                         "multiple of KV")
    return B, H, d, S, KV


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, H, d); caches: (B, S, KV, d); valid_len: device int32
    scalar. The binding enforces the kernels' limits on d, H / KV and S
    and sizes the split workspaces. Scores are scaled by d**-0.5.
    Returns (B, H, d)."""
    d = _dims(q, k_cache, v_cache)[2]
    check_cuda_operand(q, "q")
    check_cuda_operand(k_cache, "k_cache", q.dtype)
    check_cuda_operand(v_cache, "v_cache", q.dtype)
    check_cuda_operand(valid_len, "valid_len", torch.int32)
    out = torch.empty_like(q)
    load_kernels()
    torch.ops.repro_torch.decode_attention(q, k_cache, v_cache, valid_len,
                                           out, d ** -0.5)
    LAUNCH_COUNTS["decode_attention"] += 1
    return out


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """Plain PyTorch version: masked softmax over the cache in float32.
    ``valid_len`` may be an int or a scalar tensor on q's device. As in
    the kernels, masked probabilities are zeroed after the softmax, so
    ``valid_len == 0`` gives zeros."""
    B, H, d, S, KV = _dims(q, k_cache, v_cache)
    G = H // KV
    qg = q.reshape(B, KV, G, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * d ** -0.5
    mask = torch.arange(S, device=q.device) < valid_len
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, d).to(q.dtype)
