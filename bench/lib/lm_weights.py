"""The LM towers' weights, made by the benchmark on the device from the
seed, in the layout of the port's arch towers (``rl/networks``:
``{"backbone": {"embed", "ln_f", "layers": {...}}, "head", ...}``, the
layers stacked on a leading axis). One generator a tower, one draw a
leaf, in a fixed order, so that a tower, or one leaf of it, can be drawn
again alone: the program's side and the reference's draw the same
numbers. Imports only torch.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

TOWERS = ("actor", "critic0", "critic1")


def tower_seed(seed: int, tower: str) -> int:
    return (seed * 1000003 + 7919 * (TOWERS.index(tower) + 1)) % (2 ** 63)


def leaf_specs(cfg: dict, tower: str):
    """(path, shape, init) of every leaf of ``tower`` in draw order; init
    is ("normal", std) or ("const", value)."""
    L, d, f = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    A, V = cfg["act_dim"], cfg["vocab_size"]
    fan = lambda n, scale=1.0: ("normal", scale / math.sqrt(n))
    specs = [
        ("backbone.embed", (V, d), ("normal", 0.02)),
        ("backbone.ln_f.w", (d,), ("const", 1.0)),
        ("backbone.layers.ln1.w", (L, d), ("const", 1.0)),
        ("backbone.layers.attn.wq", (L, d, H * hd), fan(d)),
        ("backbone.layers.attn.wk", (L, d, KV * hd), fan(d)),
        ("backbone.layers.attn.wv", (L, d, KV * hd), fan(d)),
        ("backbone.layers.attn.wo", (L, H * hd, d), fan(H * hd)),
        ("backbone.layers.ln2.w", (L, d), ("const", 1.0)),
        ("backbone.layers.mlp.w_gate", (L, d, f), fan(d)),
        ("backbone.layers.mlp.w_up", (L, d, f), fan(d)),
        ("backbone.layers.mlp.w_down", (L, f, d), fan(f)),
    ]
    if tower == "actor":
        specs += [("head.w", (d, 2 * A), fan(d)),
                  ("head.b", (2 * A,), ("const", 0.0))]
    else:
        specs += [("act_in.w", (A, d), fan(A, 3.0)),
                  ("mix.w", (d, d), fan(d)),
                  ("mix.b", (d,), ("const", 0.0)),
                  ("head.w", (d, 1), fan(d)),
                  ("head.b", (1,), ("const", 0.0))]
    return specs


def leaves(cfg: dict, seed: int, tower: str, device
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, float32 leaf) of ``tower``, drawn one at a time."""
    gen = torch.Generator(device=device).manual_seed(tower_seed(seed, tower))
    for path, shape, (kind, v) in leaf_specs(cfg, tower):
        if kind == "normal":
            yield path, torch.randn(shape, generator=gen,
                                    device=device).mul_(v)
        else:
            yield path, torch.full(shape, v, device=device)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        *keys, last = path.split(".")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def tower(cfg: dict, seed: int, name: str, device) -> dict:
    return nest(dict(leaves(cfg, seed, name, device)))
