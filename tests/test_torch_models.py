"""The port's LM model stack against the JAX package, on the CPU: configs
(dense, ssm and hybrid), layers (RMSNorm, RoPE, SwiGLU), attention
(prefill and one decode step with its cache write, the sliding-window
ring included), one dense layer, parameter counts and layouts, and the
interop round trip (the SSM block is held in ``test_torch_ssm.py``, the
factory's prefill and decode steps in ``test_torch_serve.py``).
Parameters and tokens are the reference's, carried across
through numpy (``repro_torch.interop``); the JAX side runs its Pallas
kernels in interpret mode (``use_pallas(True)``), the port its plain
versions.

Tolerance: float32 compute, 1e-5 relative and 2e-5 absolute (XLA's and
PyTorch's CPU kernels sum in different orders, and their sin, cos and
pow differ in the last bits, which RoPE at positions up to ~100 scales).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.kernels.ops import use_pallas
from repro.models import attention as jattn
from repro.models import factory as jfactory
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch._tree import tree_leaves
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rope as trope
from repro_torch.models import attention as tattn
from repro_torch.models import factory as tfactory
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 2e-5
DENSE = ("qwen2-0.5b", "smollm-360m", "h2o-danube-1.8b")
PORTED = DENSE + ("mamba2-130m", "zamba2-1.2b", "qwen2.5-32b",
                  "mixtral-8x7b", "kimi-k2-1t-a32b", "whisper-medium",
                  "paligemma-3b")


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def t(a):
    return torch.from_numpy(np.array(a))


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def jrun(fn, *arrays, pallas=True, **static):
    """The reference's ``fn`` under ``jax.jit`` (much faster than eager
    dispatch of the interpreted Pallas kernels), on its Pallas kernels
    (``pallas=True``) or its jnp path."""
    with use_pallas(pallas):
        return jax.jit(functools.partial(fn, **static))(*arrays)


def jax_params(cfg, seed=0):
    """The reference's parameters as numpy, and the port's copy of them."""
    p = jax.tree.map(np.asarray, jax.jit(jfactory.init_params,
                                         static_argnums=0)(
        cfg, jax.random.PRNGKey(seed)))
    return p, interop.to_tensors(p, "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference(arch):
    want = jax_get_config(arch)
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert dataclasses.asdict(got.reduced(num_layers=5)) == \
        dataclasses.asdict(want.reduced(num_layers=5))
    assert sorted(ARCHS) == sorted(PORTED)


def test_unported_arch_and_family_raise():
    """Every architecture and family of the reference is ported: an
    unknown arch, shape or family raises, naming the known ones."""
    with pytest.raises(KeyError, match="mixtral-8x7b"):
        get_config("mixtral-8x7b-instruct")
    with pytest.raises(KeyError, match="decode_32k"):
        get_shape("decode_64k")
    assert get_shape("decode_32k").is_decode
    assert get_shape("decode_32k").seq_len == 32_768
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family.*moe"):
        tfactory.init_params(cfg, torch.Generator())


# ---------------------------------------------------------------------------
# parameters: layout, counts, interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_init_params_layout_matches_the_reference(arch):
    """Same tree, same shapes, same dtypes, leaf for leaf (JAX's shapes via
    ``eval_shape``, the port's on the meta device: nothing is drawn)."""
    cfg = get_config(arch).reduced()
    want = jax.eval_shape(lambda k: jfactory.init_params(
        jax_get_config(arch).reduced(), k), jax.random.PRNGKey(0))
    got = tfactory.init_params(cfg, torch.Generator(), device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x, got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32


def test_count_params_analytic_qwen2_full_width():
    """494,032,768 parameters, counted analytically and as the leaves of
    ``init_params`` on the meta device (no memory is allocated)."""
    cfg = get_config("qwen2-0.5b")
    meta = tfactory.init_params(cfg, torch.Generator(), device="meta")
    n = sum(leaf.numel() for leaf in tree_leaves(meta))
    assert n == tfactory.count_params_analytic(cfg) == 494_032_768
    assert cfg.param_count() == jfactory.count_params_analytic(
        jax_get_config("qwen2-0.5b"))


@pytest.mark.parametrize("arch", PORTED)
def test_count_params_analytic_matches_the_reference(arch):
    assert tfactory.count_params_analytic(get_config(arch)) == \
        jfactory.count_params_analytic(jax_get_config(arch))


def test_lm_interop_round_trip_is_bitwise():
    """Parameters (float32) and a bfloat16 KV cache from the reference
    survive numpy -> port -> numpy bit for bit, dtypes kept."""
    cfg = jax_get_config("qwen2-0.5b").reduced()
    want_p, port_p = jax_params(cfg)
    cache = jfactory.init_cache(cfg, 2, 8, dtype=jnp.bfloat16)
    want_c = jax.tree.map(lambda c: np.asarray(
        jnp.asarray(rand(11, *c.shape)).astype(jnp.bfloat16)), cache)
    port_c = interop.to_tensors(want_c, "cpu")
    assert port_c["k"].dtype == torch.bfloat16
    assert port_p["layers"]["attn"]["wq"].dtype == torch.float32
    for want, port in ((want_p, port_p), (want_c, port_c)):
        back = interop.to_numpy(port)
        lw, lb = jax.tree.leaves(want), jax.tree.leaves(back)
        assert jax.tree.structure(want) == jax.tree.structure(back)
        for a, b in zip(lw, lb):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_cast_params_keeps_norms_in_float32():
    cfg = get_config("qwen2-0.5b").reduced()
    p = tfactory.cast_params(tfactory.init_params(
        cfg, torch.Generator().manual_seed(0)), torch.bfloat16)
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["bq"].dtype == torch.bfloat16
    assert p["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    for norm in (p["ln_f"]["w"], p["layers"]["ln1"]["w"],
                 p["layers"]["ln2"]["w"]):
        assert norm.dtype == torch.float32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_the_reference(theta):
    """The port's rotary op (q alone and q with k, its plain version on
    the CPU) against the reference's ``apply_rope``."""
    x = rand(1, 2, 9, 3, 64)
    pos = np.arange(90, 99)
    close(trope.rope_frequencies(64, theta),
          jlayers.rope_frequencies(64, theta))
    want = jrun(jlayers.apply_rope, jnp.asarray(x), jnp.asarray(pos),
                theta=theta)
    close(kops.rope(t(x), None, t(pos), None, theta)[0], want)
    close(kops.rope(t(x), t(x[:, :, :1]), t(pos), t(pos), theta)[1],
          want[:, :, :1])
    one = np.array([57])                       # the decode step's form
    close(kops.rope(t(x[:, :1]), None, t(one), None, theta)[0],
          jrun(jlayers.apply_rope, jnp.asarray(x[:, :1]), jnp.asarray(one),
               theta=theta))


def test_rms_norm_and_mlp_match_the_reference():
    x, w = rand(2, 2, 5, 64), rand(3, 64)
    want = jrun(jlayers.rms_norm, jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    close(tlayers.rms_norm(t(x), t(w), 1e-6), want)
    p = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(4),
                                                  64, 128))
    close(tlayers.mlp(interop.to_tensors(p, "cpu"), t(x), torch.float32),
          jrun(jlayers.mlp, p, jnp.asarray(x), compute_dtype=jnp.float32))


# ---------------------------------------------------------------------------
# attention and one dense layer
# ---------------------------------------------------------------------------

def _g7(jax_side):
    """A small config with qwen2's grouping: 14 heads over 2 KV heads of
    64 (G = 7), QKV bias, theta 1e6."""
    from repro.configs.base import ModelConfig as JaxConfig
    from repro_torch.configs.base import ModelConfig
    kw = dict(name="g7", family="dense", num_layers=2, d_model=128,
              num_heads=14, num_kv_heads=2, head_dim=64, d_ff=256,
              vocab_size=512, qkv_bias=True, rope_theta=1e6,
              tie_embeddings=True)
    return (JaxConfig if jax_side else ModelConfig)(**kw)


CONFIGS = {
    "qwen2-0.5b": lambda j: (jax_get_config if j else get_config)(
        "qwen2-0.5b").reduced(),
    "g7": _g7,
    "h2o-danube-1.8b": lambda j: (jax_get_config if j else get_config)(
        "h2o-danube-1.8b").reduced(),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pallas", [True, False])
def test_attention_prefill_matches_the_reference(name, pallas):
    jcfg, cfg = CONFIGS[name](True), CONFIGS[name](False)
    S = 80 if cfg.sliding_window else 24
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(1),
                                                      jcfg))
    x = rand(5, 2, S, cfg.d_model, scale=0.5)
    want, (wk, wv) = jrun(
        jattn.attention, p, jnp.asarray(x), pallas=pallas, cfg=jcfg,
        positions=jnp.arange(S), window=jcfg.sliding_window,
        dtype=jnp.float32, return_kv=True)
    got, (gk, gv) = tattn.attention(
        interop.to_tensors(p, "cpu"), t(x), cfg,
        positions=torch.arange(S), window=cfg.sliding_window,
        dtype=torch.float32)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    ring = tattn.cache_len_for(cfg, S + 4)
    close(tattn.to_ring(gk, S, ring), jattn.to_ring(wk, S, ring))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pos", [0, 37, 70])
def test_attention_decode_matches_the_reference(name, pos):
    """One token against a cache: the cache write (the ring slot pos % S
    under a sliding window) and the output, with the JAX side on its
    Pallas decode kernel."""
    jcfg, cfg = CONFIGS[name](True), CONFIGS[name](False)
    S = tattn.cache_len_for(cfg, 80)
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(2),
                                                      jcfg))
    x = rand(6, 2, 1, cfg.d_model, scale=0.5)
    shape = (2, S, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = rand(7, *shape), rand(8, *shape)
    want, wk, wv = jrun(
        jattn.decode_attention, p, jnp.asarray(x), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(pos), cfg=jcfg,
        window=jcfg.sliding_window, dtype=jnp.float32)
    gk, gv = t(ck), t(cv)
    got, gk2, gv2 = tattn.decode_attention(
        interop.to_tensors(p, "cpu"), t(x), gk, gv,
        torch.tensor(pos, dtype=torch.int32), cfg,
        window=cfg.sliding_window, dtype=torch.float32)
    assert gk2 is gk and gv2 is gv              # written in place
    close(got, want)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_layer_prefill_and_decode_match_the_reference(name):
    jcfg, cfg = CONFIGS[name](True), CONFIGS[name](False)
    S = 70 if cfg.sliding_window else 20
    total = S + 3
    ring = tattn.cache_len_for(cfg, total)
    p = jax.tree.map(np.asarray, jtf.init_layer(jax.random.PRNGKey(3), jcfg,
                                                kind="dense"))
    tp = interop.to_tensors(p, "cpu")
    x = rand(9, 2, S, cfg.d_model, scale=0.5)
    want, wcache = jrun(
        jtf.layer_prefill, p, jnp.asarray(x), cfg=jcfg, kind="dense",
        positions=jnp.arange(S), dtype=jnp.float32, ring_len=ring,
        seq_len=S)
    got, gcache = ttf.layer_prefill(
        tp, t(x), cfg, kind="dense", positions=torch.arange(S),
        dtype=torch.float32, ring_len=ring, seq_len=S)
    close(got, want)
    for k in ("k", "v"):
        close(gcache[k], wcache[k])
    # one decode step on the cache the prefill left, grown to `total`
    pad = ((0, 0), (0, ring - wcache["k"].shape[1]), (0, 0), (0, 0))
    wc = {k: jnp.pad(v, pad) for k, v in wcache.items()}
    gc = {k: t(np.asarray(v)) for k, v in wc.items()}
    x1 = rand(10, 2, 1, cfg.d_model, scale=0.5)
    want, wc = jrun(jtf.layer_decode, p, jnp.asarray(x1), wc, jnp.int32(S),
                    cfg=jcfg, kind="dense", dtype=jnp.float32)
    got, gc = ttf.layer_decode(tp, t(x1), gc,
                               torch.tensor(S, dtype=torch.int32), cfg,
                               kind="dense", dtype=torch.float32)
    close(got, want)
    for k in ("k", "v"):
        close(gc[k], wc[k])
