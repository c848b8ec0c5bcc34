"""The port's MoE family against the JAX package, on the CPU: the
capacity-factor ``moe_block`` (two groups of 256 tokens, and one decode
group across the batch, each dropping tokens past capacity), the routing
with tied probabilities, the expert initialisation, the bf16
initialisation, the parameter counts, and whole serving runs of reduced
``mixtral-8x7b`` (its 64-token sliding window wrapped by an 80-token
prompt) and ``kimi-k2-1t-a32b`` (a shared expert). Parameters and inputs
are the reference's or numpy's, carried across through
``repro_torch.interop``; the JAX side runs under ``jax.jit``.

Tolerances. float32 compute: ``moe_block`` within 1e-5 relative and
2e-5 absolute (the einsums sum in other orders); the serving logits
within 1e-4 of the largest logit and the greedy tokens identical.
bfloat16 compute: the logits within 2e-2 of the largest, against the
reference on its Pallas kernels (``use_pallas(True)``), as
``test_torch_serve.py``. The routing's outputs are exact: one-hot
indicators and gate values rounded to bf16 once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.models import factory as jfactory
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.models import factory
from repro_torch.models import moe
from repro_torch.serve import engine

from lm_parity import (assert_logits_close, port_run, reference_run,
                       setup)

torch.set_num_threads(2)

MOE = ("mixtral-8x7b", "kimi-k2-1t-a32b")
PROMPT = {"mixtral-8x7b": 80, "kimi-k2-1t-a32b": 24}
GEN = 5


def close(got, want, rtol=1e-5, atol=2e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def moe_params(arch, seed=0):
    jcfg = jax_get_config(arch).reduced()
    p = jax.tree.map(np.asarray, jax.jit(jmoe.init_moe, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg))
    return jcfg, get_config(arch).reduced(), p, interop.to_tensors(p, "cpu")


def dropped(x, p, cfg):
    """(token, choice) pairs past capacity in the port's routing of x."""
    B, S, D = x.shape
    T = B if S == 1 else moe._group_len(S)
    logits = (x.reshape(-1, T, D) @ p["router"]).float()
    dispatch, _, _, _ = moe._routing(logits, cfg.moe.experts_per_token,
                                     moe._capacity(T, cfg))
    return B * S * cfg.moe.experts_per_token - int(dispatch.float().sum())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,S", [(2, 512), (16, 1)])
def test_moe_block_matches_the_reference(arch, B, S):
    """S 512: two groups of 256 tokens; S 1: the decode form, one group of
    the B tokens. The inputs share an offset of 1, which tilts the router
    towards some experts, so they overflow: the test asserts that tokens
    are dropped (268 of 2048 choices at S 512, 5 of 32 at S 1)."""
    jcfg, cfg, jp, tp = moe_params(arch)
    x = (np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)) + 1.0).astype(np.float32)
    assert dropped(torch.from_numpy(x), tp, cfg) > 0
    want_y, want_aux = jax.jit(functools.partial(
        jmoe.moe_block, cfg=jcfg, dtype=jnp.float32))(jp, jnp.asarray(x))
    got_y, got_aux = moe.moe_block(tp, torch.from_numpy(x), cfg,
                                   dtype=torch.float32)
    close(got_y, want_y)
    close(got_aux, want_aux)
    assert got_y.shape == (B, S, cfg.d_model)


def test_group_len_and_capacity_match_the_reference():
    cfg = get_config("kimi-k2-1t-a32b")
    for S in (1, 40, 256, 512, 1024, 1280, 1500, 8192):
        assert moe._group_len(S) == jmoe._group_len(S)
    # kimi at the serving shape: groups of 256, 7 slots an expert
    assert (moe._group_len(1024), moe._capacity(256, cfg)) == (256, 7)


def test_routing_breaks_ties_like_the_reference():
    """Rows whose probabilities tie (equal logits, as bf16-rounded logits
    often are): the top k are the lower indices first, as ``lax.top_k``,
    and dispatch and combine are the reference's exactly; the two losses
    within 1e-6 relative (sums in another order)."""
    E, k = 8, 3
    rows = np.array([[1, 1, 1, 1, 0, 0, 0, 0],
                     [0, 2, 2, 2, 2, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0, 0, 0],
                     [3, 1, 3, 1, 3, 1, 3, 1],
                     [0, 0, 5, 0, 5, 0, 0, 5]], np.float32)
    logits = np.tile(rows, (4, 1))[None]                 # (1, T=20, E)
    vals, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    got_v, got_i = moe._top_k(torch.softmax(torch.from_numpy(logits), -1),
                              k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(vals))
    assert got_i[0, 0].tolist() == [0, 1, 2]
    for capacity in (2, 5):
        want = jax.jit(jmoe._routing, static_argnums=(1, 2))(
            jnp.asarray(logits), k, capacity)
        got = moe._routing(torch.from_numpy(logits), k, capacity)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        for g, w in zip(got[2:], want[2:]):
            close(g, w, rtol=1e-6, atol=0)


def test_expert_init_std_matches_the_reference():
    """The (E, in, out) expert weights take their fan-in from axis 1:
    std 1 / sqrt(in), within 5% of the reference's draws (not 1 /
    sqrt(E))."""
    cfg = get_config("mixtral-8x7b").reduced(max_experts=8)
    jcfg = jax_get_config("mixtral-8x7b").reduced(max_experts=8)
    tp = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    for name, fan_in in (("moe_w_gate", cfg.d_model),
                         ("moe_w_up", cfg.d_model),
                         ("moe_w_down", cfg.moe.expert_d_ff)):
        got, want = float(tp[name].std()), float(jnp.std(jp[name]))
        assert abs(got / want - 1) < 0.05, (name, got, want)
        assert abs(got * fan_in ** 0.5 - 1) < 0.05, (name, got)
    assert tp["router"].dtype == torch.float32


def test_bf16_init_equals_the_float32_init_cast():
    """kimi's card run initialises in bf16: the same numbers as a float32
    init cast afterwards, the norms and the router float32 either way."""
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    f32 = factory.init_params(cfg, torch.Generator().manual_seed(3))
    bf16 = factory.init_params(cfg, torch.Generator().manual_seed(3),
                               dtype=torch.bfloat16)
    keep = {"ln1", "ln2", "ln_f", "router"}

    def walk(a, b, path=()):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                walk(a[key], b[key], path + (key,))
        elif keep & set(path):
            assert b.dtype == torch.float32 and torch.equal(a, b), path
        else:
            assert b.dtype == torch.bfloat16, path
            assert torch.equal(a.to(torch.bfloat16), b), path

    walk(f32, bf16)


@pytest.mark.parametrize("arch", MOE)
def test_count_params_analytic_active_and_built(arch):
    """Total and active counts equal the reference's at full width, and
    the total equals the leaves ``init_params`` builds (on the meta
    device: nothing is drawn)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for active in (False, True):
        assert factory.count_params_analytic(cfg, active_only=active) == \
            jfactory.count_params_analytic(jcfg, active_only=active)
    assert cfg.active_param_count() < cfg.param_count()
    meta = factory.init_params(cfg, torch.Generator(), device="meta")
    assert sum(a.numel() for a in tree_leaves(meta)) == cfg.param_count()


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_matches_the_reference_f32(arch):
    P = PROMPT[arch]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32")
    got = engine.greedy_generate(rc, pp, pb, P, GEN)
    want = jengine.greedy_generate(jrc, params, batch, P, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_logits, want_toks = reference_run(jrc, params, batch, P, GEN)
    np.testing.assert_array_equal(got.numpy(), want_toks)
    assert_logits_close(port_run(rc, pp, pb, want_toks, P), want_logits,
                        1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_serving_logits_match_the_reference_bf16(arch):
    P = PROMPT[arch]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "bfloat16")
    want_logits, want_toks = reference_run(jrc, params, batch, P, GEN)
    assert_logits_close(port_run(rc, pp, pb, want_toks, P), want_logits,
                        2e-2)


def test_launcher_and_example_serve_kimi_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` and the serve_decode example
    (the tokens of the chosen device against the CPU's) on the CPU."""
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--arch", "kimi-k2-1t-a32b", "--reduced",
                          "--layers", "1", "--param-dtype", "bfloat16",
                          "--device", "cpu", "--batch", "2",
                          "--prompt-len", "24", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "device: cpu" in out
    assert serve_decode.main(["--arch", "kimi-k2-1t-a32b", "--device", "cpu",
                              "--gen", "4"]) == 0
    assert "identical across devices: True" in capsys.readouterr().out
