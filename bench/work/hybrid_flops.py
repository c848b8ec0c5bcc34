"""Model FLOPs of one forward of an interleaved Mamba-2 / attention
backbone (granite-4.0-h-micro's layout), counted from the
configuration's widths alone, as ``model_flops.backbone_flops`` counts a
dense one: 2 a weight a token for every matrix product (a Mamba-2
layer's ``in_proj`` and ``out_proj``, an attention layer's q, k, v and o
projections, each layer's SwiGLU MLP), 4 d a visible (query, key) pair a
head for the causal attention, and each Mamba-2 layer's SSD products as
``kernel_work.ssd_scan`` counts them. The depthwise conv, the norms and
the gates are elementwise and not counted; neither is the LM head, which
the towers do not have.
"""
from __future__ import annotations

from bench.work.kernel_work import ssd_scan, visible_pairs


def layer_flops_per_token(cfg: dict) -> dict:
    """Products a token of each layer kind, the SSD and attention's pairs
    left out: {"mamba": ..., "attention": ...}."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    inner = cfg["mamba_expand"] * d
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    H = cfg["num_attention_heads"]
    hd, kv = d // H, cfg["num_key_value_heads"]
    in_proj = 2 * inner + 2 * gn + inner // cfg["mamba_d_head"]
    mlp = 3 * d * f
    return {"mamba": 2 * (d * in_proj + inner * d + mlp),
            "attention": 2 * (2 * d * H * hd + 2 * d * kv * hd + mlp)}


def backbone_flops(cfg: dict, B: int, S: int) -> float:
    """One forward of the configuration's ``num_hidden_layers`` layers of
    ``layer_types`` at (B, S), no LM head."""
    per = layer_flops_per_token(cfg)
    H = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // H
    P = cfg["mamba_d_head"]
    scan = ssd_scan(B, S, cfg["mamba_expand"] * cfg["hidden_size"] // P, P,
                    cfg["mamba_d_state"], cfg["mamba_chunk_size"], 2).flops
    total = 0.0
    for t in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        if t == "mamba":
            total += per["mamba"] * B * S + scan
        else:
            total += per["attention"] * B * S \
                + 4 * B * H * hd * visible_pairs(S, S)
    return total
