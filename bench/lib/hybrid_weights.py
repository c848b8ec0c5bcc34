"""The towers' weights of an interleaved Mamba-2 / attention backbone
(granite-4.0-h-micro's layout), made by the benchmark on the device from
the seed, in the layout of the port's arch towers on the interleaved
family: ``{"backbone": {"embed", "ln_f", "layers": {"mamba": {...},
"attn": {...}}}, "head", ...}``, each kind's layers stacked on a leading
axis. As ``lm_weights``: one generator a tower, one draw a leaf, in a
fixed order, so a tower or one leaf can be drawn again alone, and the
program's side and the reference's draw the same numbers. Imports only
torch.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from bench.lib.lm_weights import TOWERS, nest, tower_seed

__all__ = ["TOWERS", "dims", "leaf_specs", "leaves", "tower"]


def dims(cfg: dict) -> dict:
    """The sizes the layout takes from the configuration's keys."""
    d, P = cfg["hidden_size"], cfg["mamba_d_head"]
    inner = cfg["mamba_expand"] * d
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    H = inner // P
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return {"d": d, "f": cfg["intermediate_size"], "inner": inner, "H": H,
            "conv_ch": inner + 2 * gn, "in_proj": 2 * inner + 2 * gn + H,
            "K": cfg["mamba_d_conv"], "heads": cfg["num_attention_heads"],
            "kv": cfg["num_key_value_heads"],
            "hd": d // cfg["num_attention_heads"],
            "n_mamba": sum(t == "mamba" for t in kinds),
            "n_attn": sum(t == "attention" for t in kinds)}


def leaf_specs(cfg: dict, tower: str):
    """(path, shape, init) of every leaf of ``tower`` in draw order; init
    is ("normal", std), ("const", value), ("a_log",) (log of U[1, 16]:
    A = -exp(A_log) in [-16, -1]) or ("dt_bias",) (softplus's inverse of
    a log-uniform draw in [1e-3, 1e-1]), the Mamba-2 defaults."""
    z = dims(cfg)
    d, f, M, T = z["d"], z["f"], z["n_mamba"], z["n_attn"]
    A, V = cfg["act_dim"], cfg["vocab_size"]
    fan = lambda n, scale=1.0: ("normal", scale / math.sqrt(n))
    one = ("const", 1.0)

    def block(pre, n):
        return [(f"{pre}.ln2.w", (n, d), one),
                (f"{pre}.mlp.w_gate", (n, d, f), fan(d)),
                (f"{pre}.mlp.w_up", (n, d, f), fan(d)),
                (f"{pre}.mlp.w_down", (n, f, d), fan(f))]
    m, a = "backbone.layers.mamba", "backbone.layers.attn"
    specs = [
        ("backbone.embed", (V, d), ("normal", 0.02)),
        ("backbone.ln_f.w", (d,), one),
        (f"{m}.ln1.w", (M, d), one),
        (f"{m}.ssm.in_proj", (M, d, z["in_proj"]), fan(d)),
        (f"{m}.ssm.conv_w", (M, z["K"], z["conv_ch"]), fan(z["K"])),
        (f"{m}.ssm.conv_b", (M, z["conv_ch"]), ("const", 0.0)),
        (f"{m}.ssm.A_log", (M, z["H"]), ("a_log",)),
        (f"{m}.ssm.D_skip", (M, z["H"]), one),
        (f"{m}.ssm.dt_bias", (M, z["H"]), ("dt_bias",)),
        (f"{m}.ssm.norm_w", (M, z["inner"]), one),
        (f"{m}.ssm.out_proj", (M, z["inner"], d), fan(z["inner"])),
    ] + block(m, M) + [
        (f"{a}.ln1.w", (T, d), one),
        (f"{a}.attn.wq", (T, d, z["heads"] * z["hd"]), fan(d)),
        (f"{a}.attn.wk", (T, d, z["kv"] * z["hd"]), fan(d)),
        (f"{a}.attn.wv", (T, d, z["kv"] * z["hd"]), fan(d)),
        (f"{a}.attn.wo", (T, z["heads"] * z["hd"], d),
         fan(z["heads"] * z["hd"])),
    ] + block(a, T)
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


def _draw(init, shape, gen, device) -> torch.Tensor:
    kind = init[0]
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(init[1])
    if kind == "const":
        return torch.full(shape, init[1], device=device)
    u = torch.rand(shape, generator=gen, device=device)
    if kind == "a_log":
        return torch.log(u * 15.0 + 1.0)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))                       # dt_bias


def leaves(cfg: dict, seed: int, tower: str, device
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, float32 leaf) of ``tower``, drawn one at a time."""
    gen = torch.Generator(device=device).manual_seed(tower_seed(seed, tower))
    for path, shape, init in leaf_specs(cfg, tower):
        yield path, _draw(init, shape, gen, device)


def tower(cfg: dict, seed: int, name: str, device) -> Dict[str, object]:
    return nest(dict(leaves(cfg, seed, name, device)))
