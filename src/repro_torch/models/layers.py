"""Shared layer primitives: init helpers, RMSNorm (plain and gated),
LayerNorm, SwiGLU and GELU MLPs, and the training loss's cross-entropy.

Counterpart of ``repro/models/layers.py``. Params are plain nested dicts
of tensors (the JAX package's layout: ``(in, out)`` matrices); compute
runs in a caller-selected dtype (bf16 by default) with norms in float32;
the rotary embedding is a kernel (``kernels.ops.rope``). Initialisers
draw from an explicit ``torch.Generator``; their numbers differ from
JAX's threefry, so parity tests carry the reference's parameters across
(``repro_torch.interop``) instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None, scale: float = 1.0
               ) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)), the fan-in the size of axis
    ``in_axis`` (axis 0 of an ``(in, out)`` matrix; axis 1 of the stacked
    ``(E, in, out)`` expert weights). Drawn in float32 and scaled in
    place, then cast: a ``dtype`` of bfloat16 gives the float32 draw
    rounded once, with one float32 copy of the leaf alive at a time."""
    w = torch.randn(shape, generator=gen, device=device or gen.device)
    return w.mul_(scale / (shape[in_axis] ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen,
                       device=device or gen.device).mul_(0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Through the ``rmsnorm`` kernel (its plain version on the CPU)."""
    return kops.rmsnorm(x, weight, eps=eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in float32 (the population variance), cast back to x's
    dtype. Plain PyTorch: the reference has no kernel for it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba-2 output norm: rms_norm(x * silu(z)), silu in float32 and the
    product in x's dtype, as the reference."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), weight, eps)


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


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, device=None):
    """Whisper-style 2-matrix GELU MLP (with biases)."""
    w_in = dense_init(gen, (d_model, d_ff), dtype=dtype, device=device)
    w_out = dense_init(gen, (d_ff, d_model), dtype=dtype, device=device)
    return {"w_in": w_in,
            "b_in": torch.zeros((d_ff,), dtype=dtype, device=w_in.device),
            "w_out": w_out,
            "b_out": torch.zeros((d_model,), dtype=dtype,
                                 device=w_in.device)}


def gelu_mlp(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = F.gelu(x @ p["w_in"].to(compute_dtype)
               + p["b_in"].to(compute_dtype), approximate="tanh")
    return h @ p["w_out"].to(compute_dtype) + p["b_out"].to(compute_dtype)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor = None) -> torch.Tensor:
    """Mean next-token CE in float32. logits (B, S, V), targets (B, S)
    int; with ``mask``, the masked mean over max(sum(mask), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
