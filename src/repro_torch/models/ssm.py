"""Mamba-2 (state-space duality) block: prefill over a whole prompt, and
the one-token recurrent decode step.

Counterpart of ``repro/models/ssm.py``. The prefill's chunked scan always
goes through ``kernels.ops.ssd_scan`` (the hand-written kernel on a CUDA
tensor, its plain version on a CPU tensor), where the reference chose
between its jnp ``ssd_chunked`` and its Pallas kernel with
``use_pallas``. The scan starts from ``initial_state`` when one is
given (``layer_forward(ssm_state=...)``), else from zero; the reference
took its jnp path for a given state because its Pallas kernel had no
such argument, while the port's kernel takes one. The state is carried
through every chunk and into the final state, as the reference's oracle
``ssd_ref`` carries it (its ``ssd_chunked`` keeps it for the first chunk
alone). Under a gradient the
scan goes through its backward kernel as well (``ops.ssd_scan``'s
``SSDScan``). The decode step is plain tensor code, as in the reference,
and writes ``ssm_state`` and ``conv_state`` in place into the caches it
is given.

Shapes follow the reference: heads H = d_inner / P, state N, groups G
(1 for the configs), B and C broadcast from the groups to the heads.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, gated_rms_norm


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + heads
    return d_inner, heads, conv_ch, d_in_proj


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None):
    """The reference's draws: softplus(dt_bias) log-uniform in
    [1e-3, 1e-1] (the mamba2 default) and A = -exp(A_log) uniform in
    [-16, -1]; ``A_log``, ``D_skip`` and ``dt_bias`` are float32 whatever
    ``dtype`` is."""
    s = cfg.ssm
    d_inner, H, conv_ch, d_in_proj = ssm_dims(cfg)
    device = device or gen.device
    u = torch.rand((H,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a = torch.rand((H,), generator=gen, device=device) * 15.0 + 1.0
    return {
        "in_proj": dense_init(gen, (cfg.d_model, d_in_proj), dtype=dtype,
                              device=device),
        "conv_w": dense_init(gen, (s.conv_dim, conv_ch), dtype=dtype,
                             device=device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(a),
        "D_skip": torch.ones((H,), device=device),
        "dt_bias": dt_bias,
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (d_inner, cfg.d_model), dtype=dtype,
                               device=device),
    }


def _conv_taps(xp: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """sum_k xp[:, k:k+S] * w[k] over the K taps in order, in float32:
    xp is (B, S + K - 1, C) float32, w (K, C)."""
    w = w.float()
    out = xp[:, :S] * w[0]
    for k in range(1, w.shape[0]):
        out.addcmul_(xp[:, k:k + S], w[k])
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (K,C), b: (C,). The K taps
    are shifted multiply-adds in float32 (not cuDNN, whose float32 conv
    runs in TF32 by default), rounded once to x's dtype before the bias
    is added, as the reference adds it to the conv's output."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    return _conv_taps(xp, w, S).to(x.dtype) + b


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, H, conv_ch, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt, d_inner, H, s


def _split_xbc(xBC: torch.Tensor, cfg: ModelConfig, d_inner: int, H: int):
    s = cfg.ssm
    gn = s.ngroups * s.state_dim
    lead = xBC.shape[:-1]
    x_in = xBC[..., :d_inner].reshape(lead + (H, s.head_dim))
    B_ = xBC[..., d_inner:d_inner + gn].reshape(lead + (s.ngroups,
                                                        s.state_dim))
    C_ = xBC[..., d_inner + gn:].reshape(lead + (s.ngroups, s.state_dim))
    # broadcast groups to heads (copies: the kernel reads H of them)
    rep = H // s.ngroups
    B_ = torch.repeat_interleave(B_, rep, dim=-2)
    C_ = torch.repeat_interleave(C_, rep, dim=-2)
    return x_in, B_, C_


@trace.spanned("model.ssm_mixer")
def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, dtype=torch.bfloat16,
              initial_state: Optional[torch.Tensor] = None,
              return_cache: bool = False):
    """Full-sequence Mamba-2 block. x: (B,S,D) -> (out, final_ssm_state),
    or (out, {"ssm_state", "conv_state"}) when ``return_cache`` (the
    prefill); the scan starts from ``initial_state`` (B,H,P,N) or zero.
    Each call, a checkpoint's recompute included, is one span
    ``model.ssm_mixer`` and one count of ``model.ssm_mixers``."""
    trace.count("model.ssm_mixers")
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(dtype)
    z, xBC_raw, dt, d_inner, H, s = _split_proj(zxbcdt, cfg)
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"].to(dtype),
                              p["conv_b"].to(dtype)))
    x_in, B_, C_ = _split_xbc(xBC, cfg, d_inner, H)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"])                                     # (H,)
    y, fstate = kops.ssd_scan(x_in * dt[..., None].to(dtype),
                              (dt * A).float(), B_, C_, chunk=s.chunk_size,
                              initial_state=initial_state)
    y = y + p["D_skip"].to(dtype)[None, None, :, None] * x_in
    y = gated_rms_norm(y.reshape(B, S, d_inner), z, p["norm_w"],
                       cfg.norm_eps)
    out = y @ p["out_proj"].to(dtype)
    if return_cache:
        return out, {"ssm_state": fstate,
                     "conv_state": xBC_raw[:, -(s.conv_dim - 1):]}
    return out, fstate


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    _, H, conv_ch, _ = ssm_dims(cfg)
    return {
        "ssm_state": torch.zeros((batch, H, s.head_dim, s.state_dim),
                                 dtype=dtype, device=device),
        "conv_state": torch.zeros((batch, s.conv_dim - 1, conv_ch),
                                  dtype=dtype, device=device),
    }


def ssm_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cfg: ModelConfig, dtype=torch.bfloat16):
    """Single-token recurrent step. x: (B,1,D) -> (out (B,1,D), cache), the
    cache's ``ssm_state`` and ``conv_state`` updated in place."""
    B = x.shape[0]
    zxbcdt = x @ p["in_proj"].to(dtype)
    z, xBC, dt, d_inner, H, s = _split_proj(zxbcdt, cfg)
    # depthwise conv over the last conv_dim inputs
    window = torch.cat([cache["conv_state"], xBC], dim=1)          # (B,K,C)
    conv_out = _conv_taps(window.float(), p["conv_w"].to(dtype), 1) \
        .to(dtype) + p["conv_b"].to(dtype)                        # (B,1,C)
    xBC = F.silu(conv_out)
    x_in, B_, C_ = _split_xbc(xBC, cfg, d_inner, H)                # (B,1,H,·)
    x_in, B_, C_ = x_in[:, 0], B_[:, 0], C_[:, 0]                  # (B,H,·)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])               # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A).to(dtype)
    x_dt = x_in * dt[..., None].to(dtype)
    state = cache["ssm_state"] * dA[..., None, None] \
        + x_dt[..., :, None] * B_[..., None, :]                    # (B,H,P,N)
    y = (state @ C_[..., None])[..., 0] \
        + p["D_skip"].to(dtype)[None, :, None] * x_in
    y = gated_rms_norm(y.reshape(B, 1, d_inner), z, p["norm_w"],
                       cfg.norm_eps)
    out = y @ p["out_proj"].to(dtype)
    cache["ssm_state"].copy_(state)
    cache["conv_state"].copy_(window[:, 1:])
    return out, cache
