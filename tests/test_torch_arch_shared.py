"""The arch update's shared forwards, on the CPU, in float32.

``core.model_parallel.make_arch_spreeze_update`` hands the critic loss's
forwards (the critics' backbone hidden states and the actor's ``(mean,
log_std)``) to the actor loss, so each tower's backbone runs once an
update. One update of a reduced dense backbone (smollm-360m) and of one
period of the interleaved granite-4.0-h-micro against the same step
composed in the test from ``rl.networks``' public tower functions, each
tower run where its loss needs it (the critic loss and its
``tower_grads``, the actor loss and its ``tower_grads``, then Adam on
each): both losses, every gradient leaf, every updated parameter and
every Adam moment are equal, bit for bit. An actor loss called with no
critic loss before it raises. Then the ensemble functions give the same
values, and the same gradient to the action, with the hidden states
handed over as without them. Last, ``chip_smoke.py``'s launch table of
the dense arch update (``arch_update_launches``, which the card's update
is held to) equals the meta census's kernel calls.
"""
import math
import os
import sys

import pytest
import torch

from repro_torch import trace
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.core import model_parallel as mp
from repro_torch.launch import analysis
from repro_torch.rl import networks as nets
from repro_torch.rl.base import AlgoHP
from repro_torch.train.optimizer import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(2)

A, B = 4, 3
F32 = torch.float32
# (arch, reduced() arguments, tokens a sequence): the interleaved one is
# one whole period of granite's layer_types (9 Mamba-2, 1 attention)
CONFIGS = {"dense": ("smollm-360m", dict(num_layers=2, d_model=128), 8),
           "interleaved": ("granite-4.0-h-micro", dict(d_model=64), 32)}


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    yield
    trace.reset()


def _config(which):
    arch, kw, seq = CONFIGS[which]
    return get_config(arch).reduced(**kw), seq


def _towers_and_batch(cfg, seq, seed=0):
    gen = torch.Generator().manual_seed(seed)
    actor = nets.init_arch_policy(gen, cfg, A)
    q = nets.init_arch_ensemble_q(gen, cfg, A)
    q_target = tree_map(lambda a: a * 0.99, q)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, seq),
                                     generator=gen),
             "act": torch.tanh(torch.randn((B, A), generator=gen)),
             "rew": torch.randn((B,), generator=gen),
             "done": torch.tensor([0.0, 1.0, 0.0]),
             "eps": torch.randn((B, A), generator=gen)}
    return (actor, q, q_target), batch


def _fresh(towers):
    """Copies of the towers, the actor's and critics' leaves requiring
    grad, the targets' not."""
    actor, q, q_target = (tree_map(lambda a: a.detach().clone(), t)
                          for t in towers)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    return actor, q, q_target


def _equal(got, want, what):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want) and got, what
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (what, i)


def _critic_loss(cfg, actor, q, q_target, batch):
    """The reference's arch critic loss from the public tower functions:
    5 backbone forwards (the critics, the actor, the target critics)."""
    tokens = batch["tokens"]
    q_pred = nets.arch_ensemble_q_values(q, tokens, batch["act"], cfg,
                                         dtype=F32)
    with torch.no_grad():
        mean, _ = nets.arch_policy_dist(actor, tokens, cfg, dtype=F32)
        q_next = nets.arch_ensemble_q_values(
            q_target, tokens, torch.tanh(mean), cfg,
            dtype=F32).min(dim=0).values
        target = (batch["rew"]
                  + AlgoHP().gamma * (1 - batch["done"]) * q_next)
    return torch.mean((q_pred - target[None]) ** 2)


def _actor_loss(cfg, actor, q, batch):
    """The reference's arch actor loss, as ``_critic_loss``: 3 backbone
    forwards (the actor, then the critics without a graph)."""
    tokens, eps = batch["tokens"], batch["eps"]
    mean, log_std = nets.arch_policy_dist(actor, tokens, cfg, dtype=F32)
    pre = mean + torch.exp(log_std) * eps
    logp = (-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    logp = logp - mp._TanhLogDet.apply(pre).sum(-1)
    q_a = nets.arch_min_q_of_action(q, tokens, torch.tanh(pre), cfg,
                                    dtype=F32)
    return torch.mean(0.2 * logp - q_a)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_the_update_equals_the_step_composed_from_the_towers(which,
                                                             monkeypatch):
    cfg, seq = _config(which)
    towers, batch = _towers_and_batch(cfg, seq)
    opt = make_optimizer("adam", 3e-4)

    # the step composed from the public tower functions
    actor, q, q_target = _fresh(towers)
    oa, oq = opt.init(actor), opt.init(q)
    trace.reset()
    want_cl = _critic_loss(cfg, actor, q, q_target, batch)
    want_gq = mp.tower_grads(want_cl, q)
    want_al = _actor_loss(cfg, actor, q, batch)
    want_ga = mp.tower_grads(want_al, actor)
    opt.update(want_gq, oq, q)
    opt.update(want_ga, oa, actor)
    assert trace.snapshot()["counters"]["model.backbone_forwards"] == 8
    want = (actor, q, oa, oq)

    # the update, its gradients recorded where it takes them
    actor, q, q_target = _fresh(towers)
    oa, oq = opt.init(actor), opt.init(q)
    grads, inner = [], mp.tower_grads

    def recording(loss, params):
        grads.append(inner(loss, params))
        return grads[-1]
    monkeypatch.setattr(mp, "tower_grads", recording)
    update = mp.make_arch_spreeze_update(cfg, opt, A, dtype=F32)
    trace.reset()
    cl, al = update(actor, q, q_target, oa, oq, **batch)
    assert trace.snapshot()["counters"]["model.backbone_forwards"] == 5

    assert torch.equal(cl, want_cl.detach())
    assert torch.equal(al, want_al.detach())
    _equal(grads[0], want_gq, "critic gradients")
    _equal(grads[1], want_ga, "actor gradients")
    for name, got, w in zip(("actor", "q", "actor Adam", "q Adam"),
                            (actor, q, oa, oq), want):
        _equal(got, w, name)


def test_the_actor_loss_without_a_critic_loss_before_it_raises():
    cfg, seq = _config("dense")
    towers, batch = _towers_and_batch(cfg, seq)
    actor, q, q_target = _fresh(towers)
    actor_loss, critic_loss = mp.make_arch_spreeze_losses(cfg, A, dtype=F32)
    with pytest.raises(ValueError, match="call critic_loss first"):
        actor_loss(actor, q, batch["tokens"], batch["eps"])
    critic_loss(q, q_target, actor, batch["tokens"], batch["act"],
                batch["rew"], batch["done"])
    actor_loss(actor, q, batch["tokens"], batch["eps"])
    # the hand-over is taken once
    with pytest.raises(ValueError, match="call critic_loss first"):
        actor_loss(actor, q, batch["tokens"], batch["eps"])


@pytest.mark.parametrize("which", list(CONFIGS))
def test_the_ensemble_functions_take_the_hidden_states(which):
    cfg, seq = _config(which)
    (_, q, _), batch = _towers_and_batch(cfg, seq, seed=1)
    tokens = batch["tokens"]
    hidden = []
    with torch.no_grad():
        got = nets.arch_ensemble_q_values(q, tokens, batch["act"], cfg,
                                          dtype=F32, hidden=hidden)
        want = nets.arch_ensemble_q_values(q, tokens, batch["act"], cfg,
                                           dtype=F32)
    assert torch.equal(got, want)
    assert [h.shape for h in hidden] == [(B, cfg.d_model)] * 2

    def min_q(**kw):
        act = batch["act"].clone().requires_grad_()
        v = nets.arch_min_q_of_action(q, tokens, act, cfg, dtype=F32, **kw)
        return v, torch.autograd.grad(v.sum(), act)[0]
    trace.reset()
    v_shared, g_shared = min_q(hidden=hidden)
    assert "model.backbone_forwards" not in trace.snapshot()["counters"]
    v, g = min_q()
    assert torch.equal(v_shared, v)
    assert torch.equal(g_shared, g)
    assert torch.equal(v, want.min(dim=0).values)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-0.5b"])
def test_chip_smoke_dense_launch_table_equals_the_census(arch):
    """One arch update on ``meta`` (batch 32 x 1024, chip_smoke's) of a
    3-layer cut: 5 forwards and 3 recomputes of every layer's kernels."""
    cfg = get_config(arch).reduced(num_layers=3)
    one, _ = chip_smoke.arch_rl_update_fn("meta", cfg=cfg)
    with analysis.OpCensus() as c:
        one()
    assert c.kernel_calls == chip_smoke.arch_update_launches(3)
