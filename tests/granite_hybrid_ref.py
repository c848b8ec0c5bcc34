"""Plain float32 reference of granite-4.0-h-micro's backbone (model type
granitemoehybrid with no experts), for the CPU tests of the port's
interleaved family. Plain ``torch``: it imports neither JAX nor anything
of the port, and takes the parameters in the port's layout (``embed``,
``ln_f``, ``layers.mamba`` and ``layers.attn`` stacked on a leading
axis) with the sizes in a dict (``sizes``).

Per layer of ``layer_types``: ``x += r * mixer(rmsnorm(x))`` then ``x +=
r * mlp(rmsnorm(x))``, r the residual multiplier. The Mamba-2 mixer:
``in_proj`` -> z, xBC, dt; a depthwise causal conv with a bias over xBC
-> silu -> x, B, C; dt = softplus(dt + dt_bias), unclamped; the SSD with
A = -exp(A_log), written as the Mamba-2 paper's chunked quadratic form
(arXiv:2405.21060, listing 1) in plain einsums; ``+ D x``;
``rmsnorm(y * silu(z))`` over the whole inner width; ``out_proj``. The
attention layer: GQA with no position embedding, softmax scale the
attention multiplier. The embedding times the embedding multiplier, the
tied head's logits over the logits scaling.

Departures from the published model: none in the equations; the tests
run it at reduced widths and depth.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of a over (s, t] at [t, s] for s <= t,
    -inf above the diagonal (the paper's stable ``segsum``)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    x = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd_chunked(x, dtA, B, C, chunk: int):
    """The SSD in the paper's chunked form: x (b, S, h, p) already scaled
    by dt, dtA (b, S, h), B and C (b, S, h, n), from a zero state ->
    (y (b, S, h, p), final state (b, h, p, n))."""
    b, S, h, p = x.shape
    L = min(chunk, S)
    c = S // L
    x, B, C = (t.reshape(b, c, L, *t.shape[2:]) for t in (x, B, C))
    A = dtA.reshape(b, c, L, h).permute(0, 3, 1, 2)              # b h c l
    A_cum = torch.cumsum(A, dim=-1)
    # 1. the chunks' own outputs
    decay = torch.exp(segsum(A))                                  # b h c l s
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, decay, x)
    # 2. each chunk's state from its own inputs
    to_end = torch.exp(A_cum[..., -1:] - A_cum)                   # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, to_end, x)
    # 3. the states carried over the chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))      # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)
    states, final = states[:, :-1], states[:, -1]
    # 4. the carried states' share of each output
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cum))
    return (y_diag + y_off).reshape(b, S, h, p), final


def ssd_sequential(x, dtA, B, C):
    """The recurrence one step at a time: state = exp(dtA_t) state + x_t
    B_t^T, y_t = state C_t."""
    b, S, h, p = x.shape
    state = x.new_zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(S):
        state = torch.exp(dtA[:, t])[..., None, None] * state \
            + x[:, t, :, :, None] * B[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1), state


def mamba_mixer(p: Dict[str, torch.Tensor], h: torch.Tensor, z: dict):
    """One Mamba-2 mixer over h (b, S, d)."""
    b, S, _ = h.shape
    inner, N, G, P = z["d_inner"], z["state_dim"], z["ngroups"], \
        z["ssm_head_dim"]
    H = inner // P
    zxbcdt = h @ p["in_proj"]
    gate, xBC, dt = torch.split(zxbcdt, [inner, inner + 2 * G * N, H], -1)
    K = p["conv_w"].shape[0]
    conv = F.conv1d(F.pad(xBC.transpose(1, 2), (K - 1, 0)),
                    p["conv_w"].t()[:, None, :], p["conv_b"],
                    groups=xBC.shape[-1])
    xBC = F.silu(conv.transpose(1, 2))
    xs, Bg, Cg = torch.split(xBC, [inner, G * N, G * N], -1)
    xs = xs.reshape(b, S, H, P)
    # group g serves heads [g H / G, (g + 1) H / G)
    Bh, Ch = (t.reshape(b, S, G, 1, N).expand(b, S, G, H // G, N)
              .reshape(b, S, H, N) for t in (Bg, Cg))
    dt = F.softplus(dt + p["dt_bias"])                            # b S H
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(xs * dt[..., None], dt * A, Bh, Ch, z["chunk"])
    y = y + p["D_skip"][:, None] * xs
    y = rms(y.reshape(b, S, inner) * F.silu(gate), p["norm_w"], z["eps"])
    return y @ p["out_proj"]


def attention(p: Dict[str, torch.Tensor], h: torch.Tensor, z: dict):
    """Causal GQA with no position embedding, scores scaled by the
    attention multiplier."""
    b, S, _ = h.shape
    H, KV, hd = z["num_heads"], z["num_kv_heads"], z["head_dim"]
    q = (h @ p["wq"]).reshape(b, S, H, hd).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, S, KV, hd).transpose(1, 2)
    v = (h @ p["wv"]).reshape(b, S, KV, hd).transpose(1, 2)
    k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    s = (q @ k.transpose(-1, -2)) * z["attention_multiplier"]
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return (a @ v).transpose(1, 2).reshape(b, S, H * hd) @ p["wo"]


def mlp(p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def hidden(params: dict, tokens: torch.Tensor, z: dict) -> torch.Tensor:
    """(b, S) tokens -> (b, S, d): every layer, before the final norm."""
    x = params["embed"][tokens] * z["embedding_multiplier"]
    r, eps = z["residual_multiplier"], z["eps"]
    seen = {"mamba": 0, "attention": 0}
    for t in z["layer_types"]:
        stack = params["layers"]["mamba" if t == "mamba" else "attn"]
        i = seen[t]
        seen[t] += 1
        lay = {k: {kk: vv[i] for kk, vv in v.items()}
               for k, v in stack.items()}
        h = rms(x, lay["ln1"]["w"], eps)
        mix = mamba_mixer(lay["ssm"], h, z) if t == "mamba" \
            else attention(lay["attn"], h, z)
        x = x + r * mix
        x = x + r * mlp(lay["mlp"], rms(x, lay["ln2"]["w"], eps))
    return x


def logits(params: dict, tokens: torch.Tensor, z: dict) -> torch.Tensor:
    x = rms(hidden(params, tokens, z), params["ln_f"]["w"], z["eps"])
    return (x @ params["embed"].t()) / z["logits_scaling"]


def loss(params: dict, tokens: torch.Tensor, z: dict) -> torch.Tensor:
    """Mean next-token cross-entropy, the last position left out."""
    lg = logits(params, tokens, z)[:, :-1]
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1))
