"""Plain PyTorch reference of the RL towers on llama-style backbones: an
actor and two critics, each a decoder backbone (RMSNorm, causal GQA
attention with half-split RoPE, SwiGLU MLP) read at its last position,
and the two losses of the port's arch update:

- critic: both critics' Q(s, act) regressed onto ``rew + gamma (1 - done)
  min_i Qtarget_i(s, tanh(mean))``, the target built without a gradient;
- actor: ``mean(T logp - min_i Q_i(s, a))`` for the tanh-Gaussian action
  from the draw ``eps``, the critics held constant (only their heads
  carry the gradient to the action), at the fixed temperature ``T``;

both at the current weights, then one Adam step on the critics and one
on the actor. It imports nothing of the program and computes in float32
(TF32 off) from the benchmark's inputs: the weights, drawn again from
the seed (``bench/lib/lm_weights``), and the batches. It runs in blocks
of rows, one tower's graph at a time, so it fits beside the weights and
Adam's moments. ``fp8=True`` rounds each product's operands to float8
(e4m3, one scale a tensor) first: the control of a bf16 configuration.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench.lib import lm_weights

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor (its largest
    magnitude at the format's largest), the gradient passed straight."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x.detach())


class Model:
    def __init__(self, cfg: dict, fp8: bool = False):
        self.c, self.fp8 = cfg, fp8

    def mm(self, a, w):
        return _fp8(a) @ _fp8(w) if self.fp8 else a @ w

    def rms(self, x, w):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["rms_norm_eps"]) * w

    def rope(self, x):
        """x (B, S, heads, hd): the half-split rotation by position."""
        S, hd = x.shape[1], x.shape[-1]
        half = hd // 2
        freqs = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = torch.arange(S, device=x.device, dtype=torch.float32
                           )[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, q, k, v):
        """Causal attention, each KV head shared by H / KV query heads."""
        rep = q.shape[2] // k.shape[2]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        if self.fp8:
            q, k, v = _fp8(q), _fp8(k), _fp8(v)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True
                                              ).transpose(1, 2)

    def backbone(self, tower, tokens):
        """(B, S) tokens -> (B, d): the final norm at the last position."""
        p = tower["backbone"]
        c, B, S = self.c, tokens.shape[0], tokens.shape[1]
        H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        lay = p["layers"]
        x = p["embed"][tokens]
        for i in range(c["num_hidden_layers"]):
            h = self.rms(x, lay["ln1"]["w"][i])
            a = lay["attn"]
            q = self.rope(self.mm(h, a["wq"][i]).view(B, S, H, hd))
            k = self.rope(self.mm(h, a["wk"][i]).view(B, S, KV, hd))
            v = self.mm(h, a["wv"][i]).view(B, S, KV, hd)
            x = x + self.mm(self.attention(q, k, v).reshape(B, S, H * hd),
                            a["wo"][i])
            h = self.rms(x, lay["ln2"]["w"][i])
            m = lay["mlp"]
            x = x + self.mm(F.silu(self.mm(h, m["w_gate"][i]))
                            * self.mm(h, m["w_up"][i]), m["w_down"][i])
        return self.rms(x[:, -1], p["ln_f"]["w"])

    def policy(self, p, h):
        out = self.mm(h, p["head"]["w"]) + p["head"]["b"]
        mean, log_std = out.chunk(2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def q_head(self, p, h, act):
        h = h + self.mm(act, p["act_in"]["w"])
        h = torch.tanh(self.mm(h, p["mix"]["w"]) + p["mix"]["b"])
        return (self.mm(h, p["head"]["w"]) + p["head"]["b"])[..., 0]


def tanh_log_det(pre):
    """log(1 - tanh(pre)^2) as 2 (log 2 - pre - softplus(-2 pre)), whose
    derivative is -2 tanh(pre); log(1e-6) with no derivative where
    1 - tanh^2 is under 1e-6."""
    u = 1 - torch.tanh(pre) ** 2
    exact = 2 * (math.log(2.0) - pre - F.softplus(-2 * pre))
    return torch.where(u > 1e-6, exact, torch.full_like(pre, math.log(1e-6)))


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, lr, b1, b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))
            p.grad = None


def _flat(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix[1:]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}"))
    return out


def run(cfg: dict, seed: int, batches: Sequence[Dict[str, torch.Tensor]],
        rows: int, device, fp8: bool = False) -> dict:
    """Adam steps of the arch update, one a batch of ``batches`` (each
    {tokens, act, rew, done, eps}), every block of ``rows`` rows
    accumulated into one gradient. -> {"losses": [[critic, actor] a
    step], "grad": the first step's gradient norm by leaf, "change": the
    change's norm by leaf over the steps, "outputs": the first step's
    tower outputs by row}, the critics' leaves named as the program's
    stacked pair ("q.<path>")."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(cfg, seed, batches, rows, device, fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(cfg, seed, batches, rows, device, fp8):
    model = Model(cfg, fp8)
    towers = {t: lm_weights.tower(cfg, seed, t, device)
              for t in lm_weights.TOWERS}
    critics = ["critic0", "critic1"]
    targets = {t: {k: v.clone() for k, v in _flat(towers[t]).items()}
               for t in critics}
    targets = {t: lm_weights.nest(v) for t, v in targets.items()}
    flat = {t: _flat(towers[t]) for t in lm_weights.TOWERS}
    for leaves in flat.values():
        for v in leaves.values():
            v.requires_grad_(True)
    opt_q = Adam([v for t in critics for v in flat[t].values()], cfg["lr"])
    opt_a = Adam(list(flat["actor"].values()), cfg["lr"])
    losses, grad, outputs = [], None, None
    for batch in batches:
        B = batch["tokens"].shape[0]
        cl = al = 0.0
        rows_out = []
        for lo in range(0, B, rows):
            blk = {k: v[lo:lo + rows] for k, v in batch.items()}
            c, a, o = _block(model, cfg, towers, targets, blk, B)
            cl, al = cl + c, al + a
            rows_out.append(o)
        losses.append([cl, al])
        if grad is None:
            grad = _grad_norms(flat)
            outputs = {k: torch.cat([o[k] for o in rows_out], dim=-2
                                    if rows_out[0][k].dim() == 2
                                    and k in ("mean", "log_std") else -1)
                       for k in rows_out[0]}
        opt_q.step()
        opt_a.step()
    start = {t: dict(lm_weights.leaves(cfg, seed, t, device))
             for t in lm_weights.TOWERS}
    change = _pair({t: {k: float(torch.linalg.vector_norm(
        flat[t][k].detach() - start[t][k])) for k in flat[t]}
        for t in lm_weights.TOWERS})
    return {"losses": losses, "grad": grad, "change": change,
            "outputs": outputs}


def _pair(norms: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Per-tower norms -> the program's leaves: the actor's as they are,
    each critic leaf the norm of the stacked pair."""
    out = {f"actor.{k}": v for k, v in norms["actor"].items()}
    for k in norms["critic0"]:
        out[f"q.{k}"] = math.hypot(norms["critic0"][k], norms["critic1"][k])
    return out


def _grad_norms(flat) -> Dict[str, float]:
    return _pair({t: {k: float(torch.linalg.vector_norm(v.grad))
                      for k, v in leaves.items()}
                  for t, leaves in flat.items()})


def _block(model, cfg, towers, targets, blk, B):
    """One block of rows: its share of both losses, their gradients
    accumulated into the leaves' ``.grad``. -> (critic share, actor
    share, the towers' outputs on its rows: the actor's mean and log-std,
    the target critics' and the critics' Q values)."""
    tok = blk["tokens"]
    critics = ["critic0", "critic1"]
    out = {}
    with torch.no_grad():
        mean, log_std = model.policy(towers["actor"],
                                     model.backbone(towers["actor"], tok))
        out["mean"], out["log_std"] = mean, log_std
        a_next = torch.tanh(mean)
        out["q_next"] = torch.stack([
            model.q_head(targets[t], model.backbone(targets[t], tok), a_next)
            for t in critics])
        target = blk["rew"] + cfg["gamma"] * (1 - blk["done"]) \
            * out["q_next"].min(0).values
    hidden, cl, q_pred = {}, 0.0, []
    for t in critics:
        h = model.backbone(towers[t], tok)
        q = model.q_head(towers[t], h, blk["act"])
        loss = torch.sum((q - target) ** 2) / (len(critics) * B)
        loss.backward()
        hidden[t], cl = h.detach(), cl + loss.item()
        q_pred.append(q.detach())
    out["q_pred"] = torch.stack(q_pred)
    mean, log_std = model.policy(towers["actor"],
                                 model.backbone(towers["actor"], tok))
    eps = blk["eps"]
    pre = mean + torch.exp(log_std) * eps
    act = torch.tanh(pre)
    logp = (-0.5 * eps ** 2 - log_std - HALF_LOG_2PI).sum(-1) \
        - tanh_log_det(pre).sum(-1)
    fixed = {t: {k: (v.detach() if torch.is_tensor(v) else
                     {kk: vv.detach() for kk, vv in v.items()})
                 for k, v in towers[t].items() if k != "backbone"}
             for t in critics}
    q = torch.stack([model.q_head(fixed[t], hidden[t], act)
                     for t in critics]).min(0).values
    loss = torch.sum(cfg["temperature"] * logp - q) / B
    loss.backward()
    return cl, loss.item(), out
