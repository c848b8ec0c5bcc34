"""Shared layer primitives: init helpers, RMSNorm (plain and gated),
rotary, SwiGLU MLP.

Counterpart of ``repro/models/layers.py``. Params are plain nested dicts
of tensors (the JAX package's layout: ``(in, out)`` matrices); compute
runs in a caller-selected dtype (bf16 by default) with norms and rotary
in float32. Initialisers draw from an explicit ``torch.Generator``; their
numbers differ from JAX's threefry, so parity tests carry the reference's
parameters across (``repro_torch.interop``) instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal(0, 1 / fan_in) with the fan-in on axis 0 ((in, out))."""
    std = 1.0 / (shape[0] ** 0.5)
    return (torch.randn(shape, generator=gen, device=device or gen.device)
            * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen,
                        device=device or gen.device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Through the ``rmsnorm`` kernel (its plain version on the CPU)."""
    return kops.rmsnorm(x, weight, eps=eps)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba-2 output norm: rms_norm(x * silu(z)), silu in float32 and the
    product in x's dtype, as the reference."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), weight, eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The
    half-split layout, in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU, llama-style)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype,
                             device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype,
                             device=device),
    }


def mlp(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    w_gate = p["w_gate"].to(compute_dtype)
    w_up = p["w_up"].to(compute_dtype)
    w_down = p["w_down"].to(compute_dtype)
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
