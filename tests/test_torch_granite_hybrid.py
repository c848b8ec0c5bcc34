"""The port's interleaved family (granite-4.0-h-micro: Mamba-2 and NoPE
GQA layers in ``layer_types`` order, each with its own MLP, and the four
granite scalars) against plain float32 references, on the CPU.

- ``tests/granite_hybrid_ref.py``, the backbone, logits and loss: the
  reduced config (one whole period, both kinds, every multiplier set,
  GQA 4 / 2) at float32 compute, the port's parameters carried across.
  The loss within 1e-5 relative and each gradient leaf within 2e-5 of
  its largest value, ``tests/test_torch_trainer.py``'s levels: both
  sides sum the same float32 products in their own order (the SSD as the
  kernel's chunk loop against the paper's einsums), which moves a sum
  by a few 1e-7 of itself; the hidden state and the logits within 1e-5
  of their largest magnitude on the same ground. bf16 compute: the
  logits within 2e-2 of the largest, the serving logits' limit
  (``tests/test_torch_serve.py``).
- Both references' chunked SSD against the recurrence run one step at a
  time, within 1e-5 of the largest output (float32, other orders).
- The benchmark's reference (``bench/reference/granite_towers.py``): the
  arch towers' outputs, both arch losses and their gradients at a tiny
  size, at the levels above (the towers' outputs 1e-4 of the largest
  and the losses 1e-4 relative, as ``tests/test_torch_arch_rl.py``: the
  actor's ``log(1 - a^2)`` moves by ~1e-4 of itself near |a| = 1).
- ``chip_smoke.py``'s launch table of the interleaved arch update
  (``interleaved_update_launches``), which the card's granite update is
  held to, equals the meta census's kernel calls of that update, at
  granite's one-period cut and at a reduced config of another pattern.
- The parameter counts on ``meta``; the mixer counter (8 calls a Mamba-2
  layer an update: 5 tower forwards and 3 recomputes); and a config
  without the multipliers building the graph it built before they came:
  the op counts of a reduced smollm forward, loss and arch tower, taken
  before the family existed (torch 2.13, CPU).
"""
import dataclasses
import os
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import trace
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import ARCHS, PORT_ONLY, get_config
from repro_torch.core import model_parallel as mp
from repro_torch.launch import analysis
from repro_torch.models import factory
from repro_torch.models import transformer as tf
from repro_torch.rl import networks as nets
from repro_torch.train.optimizer import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import chip_smoke  # noqa: E402
import granite_hybrid_ref as ref  # noqa: E402
from bench.lib import hybrid_weights  # noqa: E402
from bench.reference import granite_towers  # noqa: E402
from bench.reference import llama_towers  # noqa: E402
from bench.runners.arch_rl_update_hybrid import model_config  # noqa: E402

torch.set_num_threads(2)

ARCH = "granite-4.0-h-micro"
B, S = 2, 64            # two of the reduced config's 32-token chunks


def small():
    """The reduced config (d 256, one period of 10 layers, the chunk 32),
    with GQA 4 / 2 so the grouping is exercised."""
    return dataclasses.replace(get_config(ARCH).reduced(), num_kv_heads=2)


def sizes(cfg) -> dict:
    return {"d_inner": cfg.ssm.expand * cfg.d_model,
            "state_dim": cfg.ssm.state_dim, "ngroups": cfg.ssm.ngroups,
            "ssm_head_dim": cfg.ssm.head_dim, "chunk": cfg.ssm.chunk_size,
            "eps": cfg.norm_eps, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "layer_types": cfg.layer_types,
            "embedding_multiplier": cfg.embedding_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


def params_and_tokens(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = factory.init_params(cfg, gen)
    # nonzero conv biases, so the bias is checked
    for i in range(p["layers"]["mamba"]["ssm"]["conv_b"].shape[0]):
        p["layers"]["mamba"]["ssm"]["conv_b"][i].normal_(0, 0.1,
                                                         generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    return p, tokens


def close(got, want, share):
    err = (got - want).abs().max().item()
    assert err <= share * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# the config and its registry
# ---------------------------------------------------------------------------

def test_the_published_config_and_its_registry():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ONLY and ARCH not in ARCHS and len(ARCHS) == 10
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (40, 2048, 32, 8, 64, 8192, 100352)
    assert cfg.layer_types[5::10] == ("attention",) * 4
    assert cfg.layer_types.count("mamba") == 36
    assert (cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.expand,
            cfg.ssm.conv_dim, cfg.ssm.chunk_size, cfg.ssm.ngroups) == \
        (128, 64, 2, 4, 256, 1)
    assert (cfg.embedding_multiplier, cfg.attention_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling) == \
        (12.0, 0.015625, 0.22, 8.0)
    assert not cfg.use_rope and cfg.tie_embeddings and cfg.norm_eps == 1e-5
    assert cfg.period() == 10
    red = cfg.reduced()
    assert red.layer_types == cfg.layer_types[:10] and red.num_layers == 10
    assert red.residual_multiplier == 0.22
    with pytest.raises(ValueError, match="layer_types"):
        dataclasses.replace(cfg, num_layers=12)


@pytest.mark.parametrize("types,period", [
    (("mamba", "attention") * 3, 2), (("mamba",) * 4, 1),
    (("mamba",) * 3 + ("attention",), 4),
    (("attention",) + ("mamba",) * 2 + ("attention",) + ("mamba",) * 2, 3)])
def test_reduced_keeps_one_whole_period(types, period):
    """``reduced()`` cuts ``layer_types`` to its shortest repeating
    prefix, whatever the pattern's length."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=len(types),
                              layer_types=types)
    assert cfg.period() == period
    red = cfg.reduced()
    assert red.layer_types == types[:period] and red.num_layers == period


@pytest.mark.parametrize("layers,want", [(40, 3_191_396_096),
                                         (10, 951_991_232)])
def test_parameter_counts_on_meta(layers, want):
    """The published count and the one-period cut's, built on ``meta``
    (nothing drawn) and counted analytically."""
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, num_layers=layers,
                              layer_types=full.layer_types[:layers])
    p = factory.init_params(cfg, torch.Generator(), device="meta")
    assert sum(t.numel() for t in tree_leaves(p)) == want
    assert factory.count_params_analytic(cfg) == want
    n_mamba = cfg.layer_types.count("mamba")
    assert p["layers"]["mamba"]["ssm"]["in_proj"].shape == \
        (n_mamba, 2048, 8512)
    assert p["layers"]["attn"]["attn"]["wk"].shape == \
        (layers - n_mamba, 2048, 512)


@pytest.mark.parametrize("fn", ["init_cache", "prefill", "decode_step"])
def test_serving_is_refused(fn):
    cfg = small()
    args = {"init_cache": (cfg, 1, 8), "prefill": ({}, {}, cfg, 8),
            "decode_step": ({}, None, None, None, cfg)}[fn]
    with pytest.raises(NotImplementedError, match="interleaved"):
        getattr(factory, fn)(*args)


# ---------------------------------------------------------------------------
# the references' SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, S, h, p, n):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, S, h, p, generator=g)
    dtA = -torch.rand(2, S, h, generator=g) * 2.0
    Bm = torch.randn(2, S, h, n, generator=g)
    Cm = torch.randn(2, S, h, n, generator=g)
    return x, dtA, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_test_reference_ssd_matches_the_recurrence(chunk):
    x, dtA, Bm, Cm = _ssd_inputs(chunk, 48, 3, 8, 16)
    y, final = ref.ssd_chunked(x, dtA, Bm, Cm, chunk)
    y_seq, final_seq = ref.ssd_sequential(x, dtA, Bm, Cm)
    close(y, y_seq, 1e-5)
    close(final, final_seq, 1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_bench_reference_ssd_matches_the_recurrence(groups):
    """The benchmark's copy takes B and C by group; head h reads group
    h // (heads / groups)."""
    h = 4
    x, dtA, Bm, Cm = _ssd_inputs(groups, 32, h, 8, 16)
    Bg, Cg = Bm[:, :, :groups], Cm[:, :, :groups]
    Bh, Ch = (t.repeat_interleave(h // groups, dim=2) for t in (Bg, Cg))
    y = granite_towers.ssd(x, dtA, Bg, Cg, 8)
    close(y, ref.ssd_sequential(x, dtA, Bh, Ch)[0], 1e-5)


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------

def test_hidden_state_and_logits_match_the_reference():
    cfg = small()
    p, tokens = params_and_tokens(cfg)
    with torch.no_grad():
        x = factory._embed(p, tokens, cfg, torch.float32)
        got = tf.interleaved_forward(p["layers"], x, cfg,
                                     positions=torch.arange(S),
                                     dtype=torch.float32, remat=False)
        want = ref.hidden(p, tokens, sizes(cfg))
        close(got, want, 1e-5)
        logits, aux = factory.forward(p, {"tokens": tokens}, cfg,
                                      dtype=torch.float32)
        close(logits, ref.logits(p, tokens, sizes(cfg)), 1e-5)
        assert float(aux) == 0.0


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_the_reference(remat):
    cfg = small()
    p, tokens = params_and_tokens(cfg, seed=1)
    p = tree_map(lambda t: t.requires_grad_(), p)
    loss, parts = factory.loss_fn(p, {"tokens": tokens}, cfg,
                                  dtype=torch.float32, remat=remat)
    leaves = tree_leaves(p)
    got = torch.autograd.grad(loss, leaves)
    want_loss = ref.loss(p, tokens, sizes(cfg))
    want = torch.autograd.grad(want_loss, leaves)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(
        want_loss.item())
    assert float(parts["aux"]) == 0.0
    for g, w in zip(got, want):
        close(g, w, 2e-5)


def test_bf16_logits_match_the_reference():
    cfg = small()
    p, tokens = params_and_tokens(cfg, seed=2)
    with torch.no_grad():
        logits, _ = factory.forward(p, {"tokens": tokens}, cfg,
                                    dtype=torch.bfloat16)
        close(logits.float(), ref.logits(p, tokens, sizes(cfg)), 2e-2)


# ---------------------------------------------------------------------------
# the arch towers against the benchmark's reference
# ---------------------------------------------------------------------------

TINY = {"name": "granite-tiny", "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 256, "mamba_d_state": 16, "mamba_d_head": 16,
        "mamba_expand": 2, "mamba_n_groups": 1, "mamba_d_conv": 4,
        "mamba_chunk_size": 16, "num_hidden_layers": 10,
        "layer_types": list(get_config(ARCH).layer_types[:10]),
        "position_embedding_type": "nope", "rms_norm_eps": 1e-5,
        "tie_word_embeddings": True, "embedding_multiplier": 12,
        "attention_multiplier": 0.015625, "residual_multiplier": 0.22,
        "logits_scaling": 8, "act_dim": 4, "gamma": 0.99,
        "temperature": 0.2, "lr": 3e-4}


def _tiny_batch(seed=5, rows=3, seq=32):
    g = torch.Generator().manual_seed(seed)
    A = TINY["act_dim"]
    return {"tokens": torch.randint(0, TINY["vocab_size"], (rows, seq),
                                    generator=g),
            "act": torch.tanh(torch.randn(rows, A, generator=g)),
            "rew": torch.randn(rows, generator=g),
            "done": (torch.rand(rows, generator=g) < 0.3).float(),
            "eps": torch.randn(rows, A, generator=g)}


def _program_towers(seed):
    actor = hybrid_weights.tower(TINY, seed, "actor", "cpu")
    crit = [hybrid_weights.tower(TINY, seed, t, "cpu")
            for t in ("critic0", "critic1")]
    q = tree_map(lambda a, b: torch.stack([a, b]), *crit)
    return actor, q


def test_arch_towers_and_losses_match_the_bench_reference():
    seed, batch = 11, _tiny_batch()
    cfg = model_config(TINY)
    actor, q = _program_towers(seed)
    q_target = tree_map(torch.clone, q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    actor_loss, critic_loss = mp.make_arch_spreeze_losses(
        cfg, TINY["act_dim"], dtype=torch.float32)
    cl = critic_loss(q, q_target, actor, batch["tokens"], batch["act"],
                     batch["rew"], batch["done"])
    gq = mp.tower_grads(cl, q)
    al = actor_loss(actor, q, batch["tokens"], batch["eps"])
    ga = mp.tower_grads(al, actor)
    with torch.no_grad():
        mean, log_std = nets.arch_policy_dist(actor, batch["tokens"], cfg,
                                              dtype=torch.float32)
        q_pred = nets.arch_ensemble_q_values(q, batch["tokens"],
                                             batch["act"], cfg,
                                             dtype=torch.float32)

    model = granite_towers.Model(TINY)
    towers = {t: hybrid_weights.tower(TINY, seed, t, "cpu")
              for t in hybrid_weights.TOWERS}
    targets = {t: tree_map(torch.clone, towers[t])
               for t in ("critic0", "critic1")}
    flat = {t: llama_towers._flat(towers[t]) for t in towers}
    for leaves in flat.values():
        for v in leaves.values():
            v.requires_grad_()
    want_cl, want_al, out = llama_towers._block(
        model, TINY, towers, targets, batch, batch["tokens"].shape[0])
    assert abs(cl.item() - want_cl) <= 1e-4 * abs(want_cl)
    assert abs(al.item() - want_al) <= 1e-4 * abs(want_al)
    close(mean, out["mean"], 1e-4)
    close(log_std, out["log_std"], 1e-4)
    close(q_pred, out["q_pred"], 1e-4)
    # gradients, leaf by leaf, in the program's order (tree_leaves)
    for g, (k, w) in zip(ga, flat["actor"].items()):
        close(g, w.grad, 2e-5)
    q_flat = llama_towers._flat(q)
    for g, k in zip(gq, q_flat):
        close(g, torch.stack([flat["critic0"][k].grad,
                              flat["critic1"][k].grad]), 2e-5)


def test_the_mixer_counter_reads_8_a_mamba_layer_an_update():
    """5 tower forwards and the 3 differentiated towers' recomputes, each
    running every Mamba-2 mixer once."""
    cfg = model_config(TINY)
    actor, q = _program_towers(3)
    q_target = tree_map(torch.clone, q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    opt = make_optimizer("adam", 3e-4)
    update = mp.make_arch_spreeze_update(cfg, opt, TINY["act_dim"])
    args = (opt.init(actor), opt.init(q))
    trace.reset()
    update(actor, q, q_target, *args, **_tiny_batch())
    counters = trace.snapshot()["counters"]
    assert counters["arch.updates"] == 1
    assert counters["model.backbone_forwards"] == 5
    assert counters["model.ssm_mixers"] == 8 * 9


@pytest.mark.parametrize("which", ["granite", "another pattern"])
def test_chip_smoke_launch_table_equals_the_census(which):
    """One arch update on ``meta`` (batch 32 x 1024, chip_smoke's): the
    census's kernel calls, counted as ``LAUNCH_COUNTS`` counts on the
    card, are ``interleaved_update_launches`` of its ``layer_types``."""
    if which == "granite":
        cfg = chip_smoke.granite_config()
        assert cfg.num_layers == 10 and cfg.d_model == 2048
    else:
        types = ("attention", "mamba", "mamba", "attention", "mamba")
        cfg = dataclasses.replace(small(), num_layers=5, layer_types=types)
    one, _ = chip_smoke.arch_rl_update_fn("meta", cfg=cfg)
    with analysis.OpCensus() as c:
        one()
    assert c.kernel_calls == \
        chip_smoke.interleaved_update_launches(cfg.layer_types)


# ---------------------------------------------------------------------------
# configs without the multipliers: the graph as before
# ---------------------------------------------------------------------------

class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# ops dispatched by the reduced smollm-360m (2 layers, d 256), batch
# (2, 16), before the interleaved family and its multipliers existed
BEFORE = {("forward", torch.float32): 282, ("forward", torch.bfloat16): 324,
          ("loss", torch.float32): 298, ("loss", torch.bfloat16): 341,
          ("arch", torch.float32): 284, ("arch", torch.bfloat16): 328}


@pytest.mark.parametrize("what,dtype", sorted(BEFORE, key=str))
def test_a_config_without_multipliers_builds_the_same_graph(what, dtype):
    cfg = get_config("smollm-360m").reduced()
    g = torch.Generator().manual_seed(0)
    p = factory.init_params(cfg, g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    pol = nets.init_arch_policy(g, cfg, 4)
    run = {"forward": lambda: factory.forward(p, {"tokens": tokens}, cfg,
                                              dtype=dtype, remat=False),
           "loss": lambda: factory.loss_fn(p, {"tokens": tokens}, cfg,
                                           dtype=dtype, remat=True),
           "arch": lambda: nets.arch_policy_dist(pol, tokens, cfg,
                                                 dtype=dtype)}[what]
    with _OpCount() as c:
        run()
    assert c.n == BEFORE[(what, dtype)]
