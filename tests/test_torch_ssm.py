"""The port's Mamba-2 block and the ssm / hybrid model plumbing against
the JAX package, on the CPU: the causal depthwise conv, the gated norm,
``ssm_block`` with its prefill cache (against both of the reference's
paths: its jnp ``ssd_chunked`` and its Pallas kernel in interpret mode),
``ssm_decode_step`` with its in-place cache writes, one SSM layer, the
parameter draws and layout, ``cast_params``, the hybrid's layer groups
and its caches. Parameters and inputs are the reference's or numpy's,
carried across through ``repro_torch.interop``; the JAX side runs under
``jax.jit``. Whole serving runs are held in ``test_torch_serve.py``.

Tolerances. float32 compute: 1e-5 relative and 2e-5 absolute, as
``test_torch_models.py`` (the scan sums in other orders; these inputs
keep every value below ~5). bfloat16 compute, against the reference's
Pallas path (which the port follows: the scan in float32): every
activation is rounded to bf16 at other places by XLA and PyTorch, so the
output and the caches within 1e-2 of their largest entry (0.55% and 0.6%
on these inputs).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.kernels.ops import use_pallas
from repro.models import factory as jfactory
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.models import factory as tfactory
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 2e-5
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def close_to_scale(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def t(a):
    a = np.asarray(a)
    return interop.to_tensors(a, "cpu")


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def jrun(fn, *arrays, pallas=True, **static):
    """The reference's ``fn`` under ``jax.jit``, on its Pallas kernels
    (``pallas=True``) or its jnp path."""
    with use_pallas(pallas):
        return jax.jit(functools.partial(fn, **static))(*arrays)


def configs(arch, **kw):
    """(reference config, port config), reduced."""
    return (jax_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw))


def _groups2(cfg):
    """Reduced mamba2 with two groups of B and C (each repeated to 8 of
    the 16 heads of 32), state 16."""
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, ngroups=2, state_dim=16, head_dim=32))


# SSM block cases: (reference config, port config). Reduced zamba2's SSM
# is reduced mamba2's (d_model 256, P 64, N 32), so the second case varies
# the groups, the state and the heads instead.
BLOCKS = {
    "mamba2-130m": lambda: configs("mamba2-130m"),
    "groups2": lambda: tuple(map(_groups2, configs("mamba2-130m"))),
}


def ssm_params(jcfg, seed=0):
    p = jax.tree.map(np.asarray, jax.jit(jssm.init_ssm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg))
    return p, interop.to_tensors(p, "cpu")


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 3, 10])
def test_causal_conv_matches_the_reference(S):
    x, w, b = rand(1, 2, S, 24), rand(2, 4, 24, scale=0.5), rand(3, 24)
    want = jrun(jssm._causal_conv, jnp.asarray(x), jnp.asarray(w),
                jnp.asarray(b))
    close(tssm._causal_conv(t(x), t(w), t(b)), want)


@pytest.mark.parametrize("pallas", [True, False])
def test_gated_rms_norm_matches_the_reference(pallas):
    x, z, w = rand(4, 2, 5, 96), rand(5, 2, 5, 96), rand(6, 96)
    want = jrun(jlayers.gated_rms_norm, jnp.asarray(x), jnp.asarray(z),
                jnp.asarray(w), pallas=pallas, eps=1e-5)
    close(tlayers.gated_rms_norm(t(x), t(z), t(w), 1e-5), want)


@pytest.mark.parametrize("case", sorted(BLOCKS))
@pytest.mark.parametrize("S", [64, 20])           # two chunks; one ragged
@pytest.mark.parametrize("pallas", [True, False])
def test_ssm_block_and_its_cache_match_the_reference(case, S, pallas):
    jcfg, cfg = BLOCKS[case]()
    p, tp = ssm_params(jcfg)
    x = rand(7, 2, S, cfg.d_model, scale=0.5)
    want, wcache = jrun(jssm.ssm_block, p, jnp.asarray(x), pallas=pallas,
                        cfg=jcfg, dtype=jnp.float32, return_cache=True)
    got, gcache = tssm.ssm_block(tp, t(x), cfg, dtype=torch.float32,
                                 return_cache=True)
    close(got, want)
    assert sorted(gcache) == sorted(wcache)
    for k in wcache:
        assert tuple(gcache[k].shape) == wcache[k].shape
        close(gcache[k], wcache[k])
    # without the cache: the final state
    _, fstate = tssm.ssm_block(tp, t(x), cfg, dtype=torch.float32)
    close(fstate, wcache["ssm_state"])


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_ssm_block_bf16_matches_the_reference_kernel_path(case):
    jcfg, cfg = BLOCKS[case]()
    p, _ = ssm_params(jcfg)
    tp = tfactory.cast_params(interop.to_tensors(p, "cpu"), torch.bfloat16)
    x = rand(8, 2, 64, cfg.d_model, scale=0.5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, wcache = jrun(jssm.ssm_block, p, xb, cfg=jcfg,
                        dtype=jnp.bfloat16, return_cache=True)
    got, gcache = tssm.ssm_block(tp, t(np.asarray(xb)), cfg,
                                 dtype=torch.bfloat16, return_cache=True)
    assert got.dtype == torch.bfloat16
    close_to_scale(got, want, 1e-2)
    for k in wcache:
        assert gcache[k].dtype == torch.bfloat16
        close_to_scale(gcache[k], wcache[k], 1e-2)


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_ssm_decode_step_matches_the_reference_in_place(case):
    jcfg, cfg = BLOCKS[case]()
    p, tp = ssm_params(jcfg, seed=1)
    cache = jssm.init_ssm_cache(jcfg, 2, dtype=jnp.float32)
    cache = {k: rand(9 + i, *v.shape, scale=0.5)
             for i, (k, v) in enumerate(sorted(cache.items()))}
    x = rand(11, 2, 1, cfg.d_model, scale=0.5)
    want, wcache = jrun(jssm.ssm_decode_step, p, jnp.asarray(x),
                        jax.tree.map(jnp.asarray, cache), cfg=jcfg,
                        dtype=jnp.float32)
    gcache = {k: t(v) for k, v in cache.items()}
    views = dict(gcache)
    got, gcache2 = tssm.ssm_decode_step(tp, t(x), gcache, cfg,
                                        dtype=torch.float32)
    assert gcache2 is gcache
    close(got, want)
    for k in wcache:
        assert gcache[k] is views[k]                 # written in place
        close(gcache[k], wcache[k])


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_ssm_layer_prefill_then_decode_matches_the_reference(case):
    """One SSM layer (pre-norm + block + residual): the prefill's output
    and cache, then two decode steps on that cache."""
    jcfg, cfg = BLOCKS[case]()
    p = jax.tree.map(np.asarray, jtf.init_layer(jax.random.PRNGKey(3), jcfg,
                                                kind="ssm"))
    tp = interop.to_tensors(p, "cpu")
    S = 32
    x = rand(12, 2, S, cfg.d_model, scale=0.5)
    kw = dict(kind="ssm", dtype=jnp.float32, ring_len=S, seq_len=S)
    want, wc = jrun(jtf.layer_prefill, p, jnp.asarray(x), cfg=jcfg,
                    positions=jnp.arange(S), **kw)
    got, gc = ttf.layer_prefill(tp, t(x), cfg, kind="ssm",
                                positions=torch.arange(S),
                                dtype=torch.float32, ring_len=S, seq_len=S)
    close(got, want)
    for k in wc:
        close(gc[k], wc[k])
    gc = {k: v.contiguous() for k, v in gc.items()}
    for i in range(2):
        x1 = rand(13 + i, 2, 1, cfg.d_model, scale=0.5)
        want, wc = jrun(jtf.layer_decode, p, jnp.asarray(x1), wc,
                        jnp.int32(S + i), cfg=jcfg, kind="ssm",
                        dtype=jnp.float32)
        got, gc = ttf.layer_decode(tp, t(x1), gc,
                                   torch.tensor(S + i, dtype=torch.int32),
                                   cfg, kind="ssm", dtype=torch.float32)
        close(got, want)
        for k in wc:
            close(gc[k], wc[k])


# ---------------------------------------------------------------------------
# parameters, casts, groups and caches
# ---------------------------------------------------------------------------

def test_init_ssm_draws_the_reference_ranges():
    cfg = get_config("mamba2-130m").reduced()
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert bool(((p["A_log"] >= 0) & (p["A_log"] <= math.log(16))).all())
    assert torch.equal(p["D_skip"], torch.ones_like(p["D_skip"]))
    for k in ("A_log", "D_skip", "dt_bias"):
        assert p[k].dtype == torch.float32
    half = tssm.init_ssm(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.bfloat16)
    assert half["in_proj"].dtype == torch.bfloat16
    assert half["A_log"].dtype == torch.float32      # as jnp.ones((H,))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cast_params_keeps_ssm_decays_and_norms_in_float32(arch):
    cfg = get_config(arch).reduced()
    p = tfactory.cast_params(tfactory.init_params(
        cfg, torch.Generator().manual_seed(0)), torch.bfloat16)
    s = p["layers"]["ssm"]
    for k in ("A_log", "dt_bias", "norm_w"):
        assert s[k].dtype == torch.float32, k
    for k in ("in_proj", "conv_w", "conv_b", "D_skip", "out_proj"):
        assert s[k].dtype == torch.bfloat16, k
    assert p["layers"]["ln1"]["w"].dtype == torch.float32
    assert p["ln_f"]["w"].dtype == torch.float32
    if arch == "zamba2-1.2b":
        assert p["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
        assert p["shared_attn"]["ln2"]["w"].dtype == torch.float32


@pytest.mark.parametrize("layers", [5, 6, 12, 38])
def test_hybrid_groups_match_the_reference(layers):
    jcfg = dataclasses.replace(jax_get_config("zamba2-1.2b"),
                               num_layers=layers)
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=layers)
    assert tfactory._hybrid_groups(cfg) == jfactory._hybrid_groups(jcfg)
    red = get_config("zamba2-1.2b").reduced(num_layers=5)
    assert tfactory._hybrid_groups(red) == [(0, 2), (2, 4), (4, 5)]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_init_cache_layout_matches_the_reference(arch):
    jcfg, cfg = configs(arch, num_layers=5)
    want = jfactory.init_cache(jcfg, 2, 24)
    got = tfactory.init_cache(cfg, 2, 24)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x, got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert not g.any()


def test_hybrid_decode_writes_the_stacked_caches_in_place():
    """The hybrid's decode step hands each group a slice of the core cache
    and one entry of the shared cache: the writes land in the stacks."""
    cfg = get_config("zamba2-1.2b").reduced(num_layers=5)
    params = tfactory.cast_params(tfactory.init_params(
        cfg, torch.Generator().manual_seed(0)), torch.float32)
    cache = tfactory.init_cache(cfg, 2, 8, dtype=torch.float32)
    leaves = tree_leaves(cache)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    logits, out = tfactory.decode_step(params, tok, cache,
                                       torch.tensor(0, dtype=torch.int32),
                                       cfg, dtype=torch.float32)
    assert out is cache
    assert all(a is b for a, b in zip(tree_leaves(out), leaves))
    assert logits.shape == (2, 1, cfg.vocab_size)
    # every layer's states and every shared slot 0 were written
    assert bool(cache["core"]["ssm_state"].flatten(1).any(1).all())
    assert bool(cache["core"]["conv_state"][:, :, -1].flatten(1).any(1).all())
    assert bool(cache["shared"]["k"][:, :, 0].flatten(1).any(1).all())
    assert not cache["shared"]["k"][:, :, 1:].any()


@pytest.mark.parametrize("arch,n", [("mamba2-130m", 128_983_488),
                                    ("zamba2-1.2b", 1_170_473_856)])
def test_count_params_analytic_ssm_and_hybrid_full_width(arch, n):
    """Counted analytically, as the reference counts, and as the leaves of
    ``init_params`` on the meta device (no memory is allocated)."""
    cfg = get_config(arch)
    meta = tfactory.init_params(cfg, torch.Generator(), device="meta")
    assert sum(leaf.numel() for leaf in tree_leaves(meta)) == n
    assert tfactory.count_params_analytic(cfg) == n
    assert jfactory.count_params_analytic(jax_get_config(arch)) == n
