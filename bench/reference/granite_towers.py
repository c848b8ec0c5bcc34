"""Plain PyTorch reference of the RL towers on granite-4.0-h-micro
backbones (model type granitemoehybrid with no experts): an actor and
two critics, each an interleaved Mamba-2 / attention backbone read at
its last position, with the two losses of the port's arch update and one
Adam step on each side, as ``llama_towers`` does for the llama-style
towers (whose heads, losses, Adam and float8 rounding it takes).

Per layer of ``layer_types``: ``x += r * mixer(rmsnorm(x))`` then ``x +=
r * mlp(rmsnorm(x))``, r = ``residual_multiplier``. The Mamba-2 mixer:
``in_proj`` -> z, xBC, dt; a depthwise causal conv with its bias over
xBC -> silu -> x, B, C (one group, broadcast to the heads); dt =
softplus(dt + dt_bias), unclamped; the SSD with A = -exp(A_log) in the
Mamba-2 paper's chunked quadratic form (arXiv:2405.21060, listing 1) in
plain einsums; ``+ D x``; ``rmsnorm(y * silu(z))`` over the whole inner
width; ``out_proj``. The attention: causal GQA with no position
embedding, its scores scaled by ``attention_multiplier``. The embedding
is scaled by ``embedding_multiplier``. It imports nothing of the program
and computes in float32 (TF32 off) from the benchmark's inputs: the
weights drawn again from the seed (``bench/lib/hybrid_weights``) and the
batches, in blocks of rows, one tower's graph at a time. ``fp8=True``
rounds each product's operands (the SSD's x, B and C included) to
float8 e4m3 first: the control of a bf16 configuration.

Departures from the published model: the depth is the configuration's
(one period of ``layer_types``, the deployment's pipeline stage); the
towers read ``ln_f`` of the last position with heads of their own and no
LM head, so ``logits_scaling`` has nothing to scale.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from bench.lib import hybrid_weights
from bench.reference import llama_towers as base
from bench.reference.llama_towers import _fp8


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): the sum of a over (s, t] at [t, s] for
    s <= t, -inf above the diagonal (the paper's stable ``segsum``)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    x = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, dtA, B, C, chunk: int) -> torch.Tensor:
    """x (b, S, h, p) scaled by dt, dtA (b, S, h), B and C (b, S, g, n)
    with g groups over the h heads, from a zero state -> y (b, S, h, p)."""
    b, S, h, p = x.shape
    g = B.shape[2]
    L = min(chunk, S)
    c = S // L
    x = x.reshape(b, c, L, g, h // g, p)
    B, C = (t.reshape(b, c, L, g, t.shape[-1]) for t in (B, C))
    A = dtA.reshape(b, c, L, g, h // g).permute(0, 3, 4, 1, 2)  # b g j c l
    A_cum = torch.cumsum(A, dim=-1)
    decay = torch.exp(segsum(A))                                # b g j c l s
    CB = torch.einsum("bclgn,bcsgn->bgcls", C, B)
    y = torch.einsum("bgcls,bgjcls,bcsgjp->bclgjp", CB, decay, x)
    to_end = torch.exp(A_cum[..., -1:] - A_cum)                 # b g j c l
    states = torch.einsum("bclgn,bgjcl,bclgjp->bcgjpn", B, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))    # b g j z c
    states = torch.einsum("bgjzc,bcgjpn->bzgjpn", carry, states)[:, :-1]
    y = y + torch.einsum("bclgn,bcgjpn,bgjcl->bclgjp", C, states,
                         torch.exp(A_cum))
    return y.reshape(b, S, h, p)


class Model(base.Model):
    """The backbone above; the heads, ``mm`` and ``rms`` are
    ``llama_towers.Model``'s."""

    def mixer(self, p, i, h):
        c, (b, S, _) = self.c, h.shape
        z = hybrid_weights.dims(c)
        inner, H, P = z["inner"], z["H"], c["mamba_d_head"]
        G, N = c["mamba_n_groups"], c["mamba_d_state"]
        zxbcdt = self.mm(h, p["in_proj"][i])
        gate, xBC, dt = torch.split(zxbcdt, [inner, z["conv_ch"], H], -1)
        K = z["K"]
        conv = F.conv1d(F.pad(xBC.transpose(1, 2), (K - 1, 0)),
                        p["conv_w"][i].t()[:, None, :], p["conv_b"][i],
                        groups=z["conv_ch"])
        xBC = F.silu(conv.transpose(1, 2))
        xs, Bg, Cg = torch.split(xBC, [inner, G * N, G * N], -1)
        xs = xs.reshape(b, S, H, P)
        dt = F.softplus(dt + p["dt_bias"][i])
        A = -torch.exp(p["A_log"][i])
        xdt, Bg, Cg = xs * dt[..., None], Bg.reshape(b, S, G, N), \
            Cg.reshape(b, S, G, N)
        if self.fp8:
            xdt, Bg, Cg = _fp8(xdt), _fp8(Bg), _fp8(Cg)
        y = ssd(xdt, dt * A, Bg, Cg, c["mamba_chunk_size"])
        y = y + p["D_skip"][i][:, None] * xs
        y = self.rms(y.reshape(b, S, inner) * F.silu(gate),
                     p["norm_w"][i])
        return self.mm(y, p["out_proj"][i])

    def attention_layer(self, a, i, h):
        c, (b, S, _) = self.c, h.shape
        H, KV = c["num_attention_heads"], c["num_key_value_heads"]
        hd = c["hidden_size"] // H
        q = self.mm(h, a["wq"][i]).view(b, S, H, hd).transpose(1, 2)
        k = self.mm(h, a["wk"][i]).view(b, S, KV, hd).transpose(1, 2)
        v = self.mm(h, a["wv"][i]).view(b, S, KV, hd).transpose(1, 2)
        k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        if self.fp8:
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        o = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=c["attention_multiplier"])
        return self.mm(o.transpose(1, 2).reshape(b, S, H * hd), a["wo"][i])

    def mlp(self, m, i, h):
        return self.mm(F.silu(self.mm(h, m["w_gate"][i]))
                       * self.mm(h, m["w_up"][i]), m["w_down"][i])

    def backbone(self, tower, tokens):
        """(B, S) tokens -> (B, d): the final norm at the last position."""
        p, c = tower["backbone"], self.c
        r = c["residual_multiplier"]
        x = p["embed"][tokens] * c["embedding_multiplier"]
        seen = {"mamba": 0, "attention": 0}
        for t in c["layer_types"][:c["num_hidden_layers"]]:
            lay = p["layers"]["mamba" if t == "mamba" else "attn"]
            i = seen[t]
            seen[t] += 1
            h = self.rms(x, lay["ln1"]["w"][i])
            x = x + r * (self.mixer(lay["ssm"], i, h) if t == "mamba"
                         else self.attention_layer(lay["attn"], i, h))
            h = self.rms(x, lay["ln2"]["w"][i])
            x = x + r * self.mlp(lay["mlp"], i, h)
        return self.rms(x[:, -1], p["ln_f"]["w"])


def run(cfg: dict, seed: int, batches: Sequence[Dict[str, torch.Tensor]],
        rows: int, device, fp8: bool = False) -> dict:
    """``llama_towers.run`` for these towers: Adam steps of the arch
    update, one a batch, each in blocks of ``rows`` rows -> {"losses",
    "grad", "change", "outputs"}, the critics' leaves named as the
    program's stacked pair."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(cfg, seed, batches, rows, device, fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(cfg, seed, batches, rows, device, fp8):
    model = Model(cfg, fp8)
    towers = {t: hybrid_weights.tower(cfg, seed, t, device)
              for t in hybrid_weights.TOWERS}
    critics = ["critic0", "critic1"]
    targets = {t: hybrid_weights.nest(
        {k: v.clone() for k, v in base._flat(towers[t]).items()})
        for t in critics}
    flat = {t: base._flat(towers[t]) for t in hybrid_weights.TOWERS}
    for leaves in flat.values():
        for v in leaves.values():
            v.requires_grad_(True)
    opt_q = base.Adam([v for t in critics for v in flat[t].values()],
                      cfg["lr"])
    opt_a = base.Adam(list(flat["actor"].values()), cfg["lr"])
    losses, grad, outputs = [], None, None
    for batch in batches:
        B = batch["tokens"].shape[0]
        cl = al = 0.0
        rows_out = []
        for lo in range(0, B, rows):
            blk = {k: v[lo:lo + rows] for k, v in batch.items()}
            c, a, o = base._block(model, cfg, towers, targets, blk, B)
            cl, al = cl + c, al + a
            rows_out.append(o)
        losses.append([cl, al])
        if grad is None:
            grad = base._grad_norms(flat)
            outputs = {k: torch.cat([o[k] for o in rows_out],
                                    dim=-2 if k in ("mean", "log_std")
                                    else -1)
                       for k in rows_out[0]}
        opt_q.step()
        opt_a.step()
    change = {}
    for t in hybrid_weights.TOWERS:
        change[t] = {k: float(torch.linalg.vector_norm(flat[t][k].detach()
                                                       - p0))
                     for k, p0 in hybrid_weights.leaves(cfg, seed, t, device)}
    return {"losses": losses, "grad": grad, "change": base._pair(change),
            "outputs": outputs}
