"""Mixture-of-Experts with capacity-factor dispatch (GShard-style).

Counterpart of ``repro/models/moe.py``, in plain PyTorch: the reference
computes the routing and the experts with einsums outside any Pallas
kernel, so the port's einsums run on cuBLAS (bf16 on the card).

Tokens are grouped as (B, NG, T, D), groups of at most ``MAX_GROUP_T``
tokens (at decode one group across the batch). Each token picks its top
k experts; its place in an expert's queue is a cumulative count over
the group's (token, choice) pairs, token-major, and tokens past the
expert's capacity are dropped to the residual. One-hot ``dispatch`` and
``combine`` tensors (B, NG, T, E, C) move the tokens into (B, NG, E, C)
expert slots and back. The reference builds them in bf16; each (t, e, c)
entry has one nonzero term, so they are exact: the indicator, and the
gate value rounded to bf16 once (at float32 compute too).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

MAX_GROUP_T = 256    # capacity-accounting group size (tokens)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None):
    """The router is float32 whatever ``dtype`` is, as the reference's;
    the expert weights (E, in, out) take their fan-in from axis 1."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    p = {
        "router": dense_init(gen, (d, e), device=device),
        "moe_w_gate": dense_init(gen, (e, d, f), in_axis=1, dtype=dtype,
                                 device=device),
        "moe_w_up": dense_init(gen, (e, d, f), in_axis=1, dtype=dtype,
                               device=device),
        "moe_w_down": dense_init(gen, (e, f, d), in_axis=1, dtype=dtype,
                                 device=device),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared_w_gate"] = dense_init(gen, (d, fs), dtype=dtype,
                                        device=device)
        p["shared_w_up"] = dense_init(gen, (d, fs), dtype=dtype,
                                      device=device)
        p["shared_w_down"] = dense_init(gen, (fs, d), dtype=dtype,
                                        device=device)
    return p


def _group_len(S: int) -> int:
    """T: S halved until a group holds at most MAX_GROUP_T tokens (or the
    halving no longer divides S). The reference also aligns the group
    count with its sequence shards; one device has one."""
    ng = 1
    while S // ng > MAX_GROUP_T:
        ng *= 2
        if S % ng:
            ng //= 2
            break
    return max(1, S // ng)


def _capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from a group of T tokens:
    ceil(T k int(8 cf) / (8 E)), at least one."""
    m = cfg.moe
    return max(1, -(-T * m.experts_per_token * int(
        8 * m.capacity_factor) // (m.num_experts * 8)))


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, in ``lax.top_k``'s order:
    descending, the lower index first among equal values (which
    ``torch.topk`` does not promise; bf16-rounded logits tie often)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(logits: torch.Tensor, top_k: int, capacity: int):
    """logits: (..., T, E) float32 -> dispatch, combine (..., T, E, C)
    bf16, the load-balance loss and the router z-loss."""
    T, E = logits.shape[-2:]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)               # (..., T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    onehot_e = F.one_hot(gate_idx, E).float()                # (..., T, k, E)
    lead = onehot_e.shape[:-3]
    flat = onehot_e.reshape(lead + (T * top_k, E))
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(lead + (T, top_k, E))
    pos_in_expert = (pos * onehot_e).sum(dim=-1).to(torch.int32)
    keep = (pos_in_expert < capacity).float()
    slots = torch.arange(capacity, device=logits.device)
    onehot_c = (pos_in_expert[..., None] == slots).float() * keep[..., None]
    combine = torch.einsum("...tke,...tkc->...tec",
                           onehot_e * gate_vals[..., None],
                           onehot_c).to(torch.bfloat16)
    dispatch = torch.einsum("...tke,...tkc->...tec", onehot_e,
                            onehot_c).to(torch.bfloat16)

    density = onehot_e.sum(dim=-2).mean(dim=-2)              # (..., E)
    mean_prob = probs.mean(dim=-2)
    lb_loss = E * (density * mean_prob).sum(dim=-1).mean()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return dispatch, combine, lb_loss, z_loss


def moe_block(p, x: torch.Tensor, cfg: ModelConfig, dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). At decode (S == 1) the batch is
    one group."""
    m = cfg.moe
    B, S, D = x.shape
    if S == 1:
        T = B
        xg = x.reshape(1, 1, B, D)
    else:
        T = _group_len(S)
        xg = x.reshape(B, S // T, T, D)
    capacity = _capacity(T, cfg)

    # the router product in the compute dtype, softmax and top-k in f32
    logits = (xg @ p["router"].to(dtype)).float()
    dispatch, combine, lb, zl = _routing(logits, m.experts_per_token,
                                         capacity)
    xe = torch.einsum("bgtd,bgtec->bgecd", xg, dispatch.to(dtype))
    h = F.silu(torch.einsum("bgecd,edf->bgecf", xe,
                            p["moe_w_gate"].to(dtype))) \
        * torch.einsum("bgecd,edf->bgecf", xe, p["moe_w_up"].to(dtype))
    ye = torch.einsum("bgecf,efd->bgecd", h, p["moe_w_down"].to(dtype))
    y = torch.einsum("bgecd,bgtec->bgtd", ye, combine.to(dtype))

    if m.num_shared_experts:
        hs = F.silu(xg @ p["shared_w_gate"].to(dtype)) \
            * (xg @ p["shared_w_up"].to(dtype))
        y = y + hs @ p["shared_w_down"].to(dtype)

    aux = m.load_balance_loss * lb + m.router_z_loss * zl
    return y.reshape(B, S, D), aux.float()
