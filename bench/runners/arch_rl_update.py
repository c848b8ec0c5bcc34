"""Runner of the cells whose timed path is the port's RL update of towers
on LM backbones: the ``update`` that
``core.model_parallel.make_arch_spreeze_update`` returns (the critic
loss's gradient over the two critics and the actor loss's over the
actor, at the current weights, then Adam on each), over an actor, two
critics and two target critics.

Set-up draws the towers (``bench/lib/lm_weights``) and
``distinct_batches`` batches on the device from the seed, builds the
optimizer's states and the update, and drives it through the first
``check_updates`` updates, each on its own batch; the window then calls
the same update on the same objects, cycling the batches. The reference
follows the checked updates from the same weights and batches.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import numpy as np
import torch

from bench.lib import compare, lm_weights
from bench.reference import llama_towers as reference
from bench.work import model_flops

ADAM_B1 = 0.9      # the program's Adam's first-moment rate (train/optimizer)


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for the configuration's sizes."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"])


def make_batches(cfg: dict, traffic: dict, seed: int, device):
    """``distinct_batches`` batches of random tokens, tanh-normal actions,
    normal rewards, done flags and the actor's draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B, S, A = traffic["batch"], traffic["seq"], cfg["act_dim"]
    out = []
    for _ in range(traffic["distinct_batches"]):
        out.append({
            "tokens": torch.randint(0, cfg["vocab_size"], (B, S),
                                    generator=gen, device=device),
            "act": torch.tanh(torch.randn((B, A), generator=gen,
                                          device=device)),
            "rew": torch.randn((B,), generator=gen, device=device),
            "done": (torch.rand((B,), generator=gen, device=device)
                     < traffic["done_rate"]).float(),
            "eps": torch.randn((B, A), generator=gen, device=device)})
    return out


def _stack2(a: dict, b: dict) -> dict:
    return {k: _stack2(a[k], b[k]) if isinstance(a[k], dict)
            else torch.stack([a[k], b[k]]) for k in a}


def _flat(tree, prefix: str) -> Dict[str, torch.Tensor]:
    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}"))
    return out


class Cell:
    """One run of an arch-update cell (``bench/lib/harness.py`` calls
    ``setup``, ``window``, ``traced``, ``release``, ``check``)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        s = np.random.SeedSequence(seed).generate_state(2, np.uint64)
        self.w_seed, self.b_seed = (int(x) & (2 ** 62 - 1) for x in s)
        self.tracing = False     # in the traced sub-window: spans open

    def _span(self, name):
        if not self.tracing:
            return _Null
        return torch.profiler.record_function("bench." + name)

    def setup(self) -> None:
        from repro_torch._tree import tree_leaves, tree_map
        from repro_torch.core import model_parallel as mp
        from repro_torch.train.optimizer import Optimizer, make_optimizer
        cfg, dev = self.cfg, self.device
        self.mcfg = model_config(cfg)
        self.actor = lm_weights.tower(cfg, self.w_seed, "actor", dev)
        c0 = lm_weights.tower(cfg, self.w_seed, "critic0", dev)
        c1 = lm_weights.tower(cfg, self.w_seed, "critic1", dev)
        self.q = _stack2(c0, c1)
        del c0, c1
        self.q_target = tree_map(torch.clone, self.q)
        for leaf in tree_leaves((self.actor, self.q)):
            leaf.requires_grad_()
        adam = make_optimizer("adam", cfg["lr"])

        def update_spanned(grads, state, params):
            with self._span("adam"):
                return adam.update(grads, state, params)
        opt = Optimizer(init=adam.init, update=update_spanned)
        self.opt_actor, self.opt_q = opt.init(self.actor), opt.init(self.q)
        losses = mp.make_arch_spreeze_losses

        def spanned_losses(*a, **kw):
            actor_loss, critic_loss = losses(*a, **kw)

            def al(*x, **k):
                self.phase = "actor"
                with self._span("actor_loss"):
                    return actor_loss(*x, **k)

            def cl(*x, **k):
                self.phase = "critic"
                with self._span("critic_loss"):
                    return critic_loss(*x, **k)
            return al, cl
        mp.make_arch_spreeze_losses = spanned_losses
        try:
            self.update = mp.make_arch_spreeze_update(
                self.mcfg, opt, cfg["act_dim"], dtype=_DTYPES[
                    cfg["compute_dtype"]])
        finally:
            mp.make_arch_spreeze_losses = losses
        self.batches = make_batches(cfg, self.traffic, self.b_seed, dev)
        self.step = 0
        self.captured = {"losses": []}
        for _ in range(self.traffic["check_updates"]):
            if self.step == 0:
                with _recording_outputs() as outputs:
                    cl, al = self._one()
                self.captured["outputs"] = outputs
            else:
                cl, al = self._one()
            self.captured["losses"].append((cl, al))
            if self.step == 1:
                self.captured["grad"] = {
                    k: torch.linalg.vector_norm(v) / (1.0 - ADAM_B1)
                    for k, v in self._moments().items()}
        self.captured["change"] = self._change()

    def _one(self):
        batch = self.batches[self.step % len(self.batches)]
        self.step += 1
        return self.update(self.actor, self.q, self.q_target, self.opt_actor,
                           self.opt_q, **batch)

    def _moments(self):
        return {**_flat(self.opt_actor.mu, "actor"),
                **_flat(self.opt_q.mu, "q")}

    def _change(self) -> Dict[str, torch.Tensor]:
        """The norm of each leaf's change since the start, the start drawn
        again one leaf at a time."""
        now = {"actor": _flat(self.actor, "actor"), "q": _flat(self.q, "q")}
        sq: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name in lm_weights.TOWERS:
                for path, p0 in lm_weights.leaves(self.cfg, self.w_seed, name,
                                                  self.device):
                    if name == "actor":
                        key, cur = "actor." + path, now["actor"]["actor." + path]
                    else:
                        key = "q." + path
                        cur = now["q"][key][int(name[-1])]
                    d = torch.sum((cur.detach() - p0) ** 2)
                    sq[key] = sq[key] + d if key in sq else d
        return {k: torch.sqrt(v) for k, v in sq.items()}

    def window(self, seconds: float) -> dict:
        t = self.traffic
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one()
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        c = self.cfg
        fwd = model_flops.backbone_flops(
            c["num_hidden_layers"], c["hidden_size"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["head_dim"], c["intermediate_size"], t["batch"], t["seq"])
        return {"wall_s": wall, "updates": n,
                "update_tokens_per_s": n * t["batch"] * t["seq"] / wall,
                "model_flops": n * 11 * fwd, "attempted": n, "failed": 0}

    def traced(self, tracer) -> dict:
        """Spans around each loss, its tower_grads and the Adam steps, and
        the four model kernels' calls (forward entry points and the
        backward ops the autograd Functions call) logged, over
        ``trace_updates`` updates."""
        from repro_torch.core import model_parallel as mp
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import rmsnorm as rms
        self.tracing = True
        grads = mp.tower_grads

        def tower_grads(loss, params):
            with self._span(self.phase + "_grad"):
                return grads(loss, params)
        tracer._patch(mp, "tower_grads", tower_grads)
        tracer.kernel_calls(kops, "rmsnorm", "rmsnorm", _rmsnorm_work)
        tracer.kernel_calls(kops, "flash_attention", "flash_attention",
                            _flash_work)
        tracer.kernel_calls(rms, "rmsnorm_bwd", "rmsnorm_bwd",
                            _rmsnorm_bwd_work)
        tracer.kernel_calls(fa, "flash_attention_bwd", "flash_attention_bwd",
                            _flash_bwd_work)
        n = self.traffic["trace_updates"]

        def block():
            for _ in range(n):
                self._one()
            self.tracing = False
        return {"updates": n, "block": block}

    def release(self) -> None:
        for k in ("actor", "q", "q_target", "opt_actor", "opt_q", "update",
                  "batches"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_numbers(self) -> dict:
        cap = self.captured
        return {"losses": [[float(c), float(a)] for c, a in cap["losses"]],
                "grad": {k: float(v) for k, v in cap["grad"].items()},
                "change": {k: float(v) for k, v in cap["change"].items()},
                "outputs": cap["outputs"]}

    def reference_numbers(self, fp8: bool = False) -> dict:
        batches = make_batches(self.cfg, self.traffic, self.b_seed,
                               self.device)[:self.traffic["check_updates"]]
        return reference.run(self.cfg, self.w_seed, batches,
                             self.traffic["ref_rows"], self.device, fp8=fp8)

    def control_numbers(self) -> dict:
        """The reference in the program's place, every product's operands
        rounded to float8: the step below the configuration's bf16."""
        return self.reference_numbers(fp8=True)

    def check(self) -> Dict[str, float]:
        return compare.numbers(self.program_numbers(),
                               self.reference_numbers())


@contextlib.contextmanager
def _recording_outputs():
    """Record what the first update's towers put out (their rows, as
    float32 copies): the critics' Q values of the batch's actions, the
    actor's mean and log-std, and the target critics' Q values, taken
    where the program's losses call them (``rl/networks``)."""
    from repro_torch.rl import networks as nets
    out: Dict[str, torch.Tensor] = {}
    ens, pol = nets.arch_ensemble_q_values, nets.arch_policy_dist

    def ensemble(*a, **kw):
        q = ens(*a, **kw)
        out["q_next" if "q_pred" in out else "q_pred"] = \
            q.detach().float().clone()
        return q

    def policy(*a, **kw):
        mean, log_std = pol(*a, **kw)
        if "mean" not in out:
            out["mean"] = mean.detach().float().clone()
            out["log_std"] = log_std.detach().float().clone()
        return mean, log_std
    nets.arch_ensemble_q_values, nets.arch_policy_dist = ensemble, policy
    try:
        yield out
    finally:
        nets.arch_ensemble_q_values, nets.arch_policy_dist = ens, pol


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_Null = _NullSpan()
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _rmsnorm_work(x, weight, *, eps=1e-6):
    from bench.work import kernel_work
    w = kernel_work.rmsnorm(x.numel() // x.shape[-1], x.shape[-1], x.dtype)
    return lambda: w


def _rmsnorm_bwd_work(x, weight, dy, *, eps=1e-6):
    from bench.work import kernel_work
    w = kernel_work.rmsnorm_bwd(x.numel() // x.shape[-1], x.shape[-1],
                                x.dtype)
    return lambda: w


def _flash_work(q, k, v, *, causal=True, window=None, prefix_len=None):
    from bench.work import kernel_work
    lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    w = kernel_work.flash_attention(
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], q.dtype, causal=causal, window=window,
        prefix_len=prefix_len, lse=lse)
    return lambda: w


def _flash_bwd_work(q, k, v, out, lse, dout, *, causal=True, window=None,
                    prefix_len=None):
    from bench.work import kernel_work
    w = kernel_work.flash_attention_bwd(
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], q.dtype, causal=causal, window=window,
        prefix_len=prefix_len)
    return lambda: w
