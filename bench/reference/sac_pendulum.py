"""Plain PyTorch reference of the Spreeze megastep's first updates: SAC
(tanh-Gaussian actor, twin critics, the min-target, a tuned temperature,
Adam, polyak averaging) on batched Pendulum-v0, with the replay ring and
uniform or prioritized (Gumbel top-k, APE-X weights) replay.

It imports nothing of the program: it follows the configuration's
equations from the benchmark's own inputs (the initial weights and env
states, and the draws the trainer was handed, in the order it took
them) and works out again everything the program derives from them: the
experience, the ring, the batches, the losses, the gradients and the
optimizer's state. Everything is float32; ``tf32=True`` computes the
products in TF32, the control of a float32 configuration.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List

import torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
FIELDS = ("obs", "act", "rew", "next_obs", "done", "disc")


def flat(prefix: str, tree) -> Dict[str, torch.Tensor]:
    """A nested dict of tensors -> {"prefix.key.key": tensor}."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(f"{prefix}.{k}", v))
    return out


def mlp(p, x):
    """x @ w + b through ``l0 .. ln``, relu between; a stacked tower's
    leading axis broadcasts."""
    n = len(p)
    for i in range(n):
        x = torch.matmul(x, p[f"l{i}"]["w"]) + p[f"l{i}"]["b"].unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x


def sample_action(actor, obs, eps):
    mean, log_std = mlp(actor, obs).chunk(2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = (-0.5 * (eps ** 2) - log_std - HALF_LOG_2PI).sum(-1)
    logp = logp - torch.log(torch.clamp(1 - act ** 2, min=1e-6)).sum(-1)
    return act, logp


def q_values(q, obs, act):
    return mlp(q, torch.cat([obs, act], dim=-1))[..., 0]


class Pendulum:
    """gym's Pendulum-v0, batched; the constants from the configuration."""

    def __init__(self, env: dict):
        self.__dict__.update(env)

    def observe(self, s):
        return torch.stack([torch.cos(s["th"]), torch.sin(s["th"]),
                            s["thdot"]], dim=-1)

    def autoreset_step(self, s, a, fresh_th, fresh_thdot):
        th, thdot = s["th"], s["thdot"]
        u = torch.clamp(a[..., 0], -1.0, 1.0) * self.max_torque
        norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (3 * self.g / (2 * self.length) * torch.sin(th)
                            + 3.0 / (self.m * self.length ** 2) * u
                            ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        t = s["t"] + 1
        done = t >= self.episode_len
        nxt = {"th": torch.where(done, fresh_th, th + newthdot * self.dt),
               "thdot": torch.where(done, fresh_thdot, newthdot),
               "t": torch.where(done, torch.zeros_like(t), t)}
        return nxt, self.observe(nxt), -cost, done


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = (
            params, lr, b1, b2, eps)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))


class Ring:
    """The replay pool: rows written at ``(ptr + i) % capacity``; with
    ``per`` each new row enters at the current max priority."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device,
                 per: bool):
        dims = {"obs": obs_dim, "act": act_dim, "next_obs": obs_dim}
        self.data = {k: torch.zeros((capacity, dims[k]) if k in dims
                                    else (capacity,), device=device)
                     for k in FIELDS}
        self.cap, self.ptr, self.size = capacity, 0, 0
        self.pri = torch.zeros(capacity, device=device) if per else None
        self.max_p = torch.ones((), device=device)

    def write(self, rows: Dict[str, torch.Tensor]) -> None:
        n = rows["rew"].shape[0]
        slots = (self.ptr + torch.arange(n, device=rows["rew"].device)
                 ) % self.cap
        for k in FIELDS:
            self.data[k][slots] = rows[k]
        if self.pri is not None:
            self.pri[slots] = self.max_p
        self.ptr = (self.ptr + n) % self.cap
        self.size = min(self.size + n, self.cap)


def run(cfg: dict, traffic: dict, weights: dict, env0: dict,
        draws: Iterator, updates: int, device, tf32: bool = False) -> dict:
    """The trainer's warm-up, then rounds (a sampler chunk, the ring
    write, ``updates_per_round`` updates) until ``updates`` updates have
    run. ``draws`` yields, in the trainer's order, ``("sampler", eps, th,
    thdot)`` for each env step and ``("update", raw, eps_next,
    eps_actor)`` or ``("per", gumbel, eps_next, eps_actor)`` for each
    update. -> {"losses": [[critic, actor] an update], "grad": the first
    update's gradient norm by leaf, "change": the change's norm by leaf}.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _run(cfg, traffic, weights, env0, draws, updates, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(cfg, traffic, weights, env0, draws, updates, device):
    if cfg["nstep"] != 1:
        raise ValueError("the reference follows one-step returns only")
    env = Pendulum(cfg["env"])
    gamma, tau, lr = cfg["gamma"], cfg["tau"], cfg["lr"]
    per = traffic["prioritized"]
    N, T = traffic["num_envs"], traffic["chunk_len"]
    B = traffic["batch_size"]
    act_dim = cfg["env"]["act_dim"]
    target_entropy = -cfg["target_entropy_scale"] * act_dim
    clone = lambda tree: {k: clone(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.detach().clone()
    actor, q = clone(weights["actor"]), clone(weights["q"])
    q_t = clone(q)
    log_alpha = torch.tensor(math.log(cfg["init_alpha"]), device=device)
    start = {**flat("actor", actor), **flat("q", q), **flat("q_target", q_t),
             "log_alpha": log_alpha}
    start = {k: v.clone() for k, v in start.items()}
    a_leaves, q_leaves = list(flat("actor", actor).values()), \
        list(flat("q", q).values())
    opt_a, opt_q = Adam(a_leaves, lr), Adam(q_leaves, lr)
    opt_al = Adam([log_alpha], lr)
    state = {k: v.clone() for k, v in env0.items()}
    ring = Ring(cfg["replay_capacity"], cfg["env"]["obs_dim"], act_dim,
                device, per)

    def chunk():
        nonlocal state
        rows = {k: [] for k in FIELDS[:5]}
        with torch.no_grad():
            for _ in range(T):
                kind, eps, th, thdot = next(draws)
                assert kind == "sampler", kind
                obs = env.observe(state)
                a, _ = sample_action(actor, obs, eps)
                state, nobs, rew, done = env.autoreset_step(state, a, th,
                                                            thdot)
                for k, v in zip(FIELDS[:5], (obs, a, rew, nobs,
                                             done.float())):
                    rows[k].append(v)
        rows = {k: torch.stack(v).reshape((T * N,) + v[0].shape[1:])
                for k, v in rows.items()}
        rows["disc"] = gamma * (1.0 - rows["done"])
        ring.write(rows)

    losses, grad = [], None
    frames = 0
    while frames < traffic["warmup_frames"]:
        chunk()
        frames += N * T
    done_updates = 0
    while done_updates < updates:
        chunk()
        for _ in range(traffic["updates_per_round"]):
            if done_updates == updates:
                break
            kind, first, eps_next, eps_actor = next(draws)
            w = None
            if per:
                assert kind == "per", kind
                idx, w = _per_sample(ring, first, B, cfg["per_alpha"],
                                     cfg["per_beta"])
            else:
                assert kind == "update", kind
                idx = first.long() % max(ring.size, 1)
                if ring.size >= ring.cap:
                    idx = (idx + ring.ptr) % ring.cap
            batch = {k: v[idx] for k, v in ring.data.items()}
            out = _update(actor, q, q_t, log_alpha, opt_a, opt_q, opt_al,
                          batch, w, eps_next, eps_actor, tau,
                          target_entropy, cfg["autotune_alpha"])
            losses.append([out["critic_loss"], out["actor_loss"]])
            if grad is None:
                grad = out["grads"]
            if per:
                new = torch.abs(out["td_abs"]) + 1e-3
                ring.pri[idx] = new
                ring.max_p = torch.maximum(ring.max_p, new.max())
            done_updates += 1
    end = {**flat("actor", actor), **flat("q", q), **flat("q_target", q_t),
           "log_alpha": log_alpha}
    return {"losses": losses,
            "grad": grad,
            "change": {k: float(torch.linalg.vector_norm(end[k] - start[k]))
                       for k in start}}


def _per_sample(ring: Ring, gumbel, B: int, alpha: float, beta: float):
    """APE-X replay: the B best Gumbel scores ``alpha log p + g`` (a
    stable descending sort), cycled over the live rows; importance
    weights ``(n p^alpha / sum p^alpha)^-beta`` over the max."""
    p = ring.pri
    live = p > 0.0
    scores = torch.where(live, alpha * torch.log(torch.clamp(p, min=1e-12)),
                         float("-inf")) + gumbel
    order = torch.sort(scores, descending=True, stable=True).indices[:B]
    n_live = max(int(live.sum()), 1)
    idx = order[torch.arange(B, device=p.device) % n_live]
    pa = torch.where(live, torch.clamp(p, min=1e-12) ** alpha, 0.0)
    z = torch.clamp(pa.sum(), min=1e-12)
    w = (float(n_live) * (pa[idx] / z)) ** (-beta)
    return idx, w / torch.clamp(w.max(), min=1e-12)


def _update(actor, q, q_t, log_alpha, opt_a, opt_q, opt_al, batch, w,
            eps_next, eps_actor, tau, target_entropy, autotune):
    """One SAC update in place; -> losses, the gradients' norms by leaf
    and the per-sample |TD| (mean over the critics)."""
    with torch.no_grad():
        alpha = torch.exp(log_alpha)
        next_a, next_logp = sample_action(actor, batch["next_obs"], eps_next)
        q_next = q_values(q_t, batch["next_obs"], next_a).min(dim=0).values
        target = batch["rew"] + batch["disc"] * (q_next - alpha * next_logp)
    q_leaves = list(flat("q", q).values())
    for t in q_leaves:
        t.requires_grad_(True)
    qs = q_values(q, batch["obs"], batch["act"])
    se = (qs - target) ** 2
    if w is not None:
        se = se * w
    critic_loss = torch.mean(se)
    gq = torch.autograd.grad(critic_loss, q_leaves)
    for t in q_leaves:
        t.requires_grad_(False)
    opt_q.step(gq)
    td_abs = torch.abs(qs.detach() - target).mean(0)

    a_leaves = list(flat("actor", actor).values())
    for t in a_leaves:
        t.requires_grad_(True)
    a, logp = sample_action(actor, batch["obs"], eps_actor)
    actor_loss = torch.mean(alpha * logp
                            - q_values(q, batch["obs"], a).min(dim=0).values)
    ga = torch.autograd.grad(actor_loss, a_leaves)
    for t in a_leaves:
        t.requires_grad_(False)
    opt_a.step(ga)
    g_alpha = -(logp.detach().mean() + target_entropy)
    if autotune:
        opt_al.step([g_alpha])
    with torch.no_grad():
        for t, o in zip(flat("q", q_t).values(), q_leaves):
            t.mul_(1 - tau).add_(tau * o)
    norm = lambda g: float(torch.linalg.vector_norm(g))
    grads = {k: norm(g) for k, g in zip(flat("q", q), gq)}
    grads.update({k: norm(g) for k, g in zip(flat("actor", actor), ga)})
    grads["log_alpha"] = norm(g_alpha)
    return {"critic_loss": critic_loss.item(),
            "actor_loss": actor_loss.item(),
            "grads": grads, "td_abs": td_abs}
