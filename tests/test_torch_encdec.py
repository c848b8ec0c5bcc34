"""The port's enc-dec family (whisper) against the JAX package, on the
CPU: LayerNorm, the tanh-GELU MLP, the sinusoidal positions, the encoder
(``_encode``: non-causal self attention over the frame embeddings), one
cross-attention decode step against the memory's cache, the cache
growth (the memory's ``xk``/``xv`` stay as they are), and whole serving
runs of reduced ``whisper-medium`` (2 + 2 layers, 32 frames): the
prefill (the encoder, then the decoder's causal self attention and its
cross attention) and greedy decode steps. Parameters, frames and prompts
are the reference's, carried across through ``repro_torch.interop``; the
JAX side runs under ``jax.jit`` on its Pallas kernels in interpret mode
(``use_pallas(True)``).

Tolerances. float32 compute: layers and the encoder within 1e-5
relative and 2e-5 absolute (sums in other orders); the serving logits
within 1e-4 of the largest logit and the greedy tokens identical.
bfloat16 compute: the logits within 2e-2 of the largest, as
``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.kernels.ops import use_pallas
from repro.models import attention as jattn
from repro.models import factory as jfactory
from repro.models import layers as jlayers
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import factory
from repro_torch.models import layers as tlayers
from repro_torch.serve import engine

from lm_parity import (assert_logits_close, port_run, reference_run,
                       setup)

torch.set_num_threads(2)

ARCH = "whisper-medium"
P, GEN = 12, 5


def close(got, want, rtol=1e-5, atol=2e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def configs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def test_layer_norm_and_gelu_mlp_match_the_reference():
    x, w, b = rand(1, 2, 5, 64) * 3 + 1, rand(2, 64), rand(3, 64)
    close(tlayers.layer_norm(t(x), t(w), t(b), 1e-5),
          jax.jit(functools.partial(jlayers.layer_norm, eps=1e-5))(
              jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    p = jax.tree.map(np.asarray, jlayers.init_gelu_mlp(
        jax.random.PRNGKey(4), 64, 128))
    p = {k: v + 0.1 * rand(5, *v.shape) for k, v in p.items()}  # biases
    close(tlayers.gelu_mlp(interop.to_tensors(p, "cpu"), t(x), torch.float32),
          jax.jit(functools.partial(jlayers.gelu_mlp,
                                    compute_dtype=jnp.float32))(
              p, jnp.asarray(x)))


def test_sinusoid_matches_the_reference():
    close(factory._sinusoid(1500, 64, torch.float32),
          jfactory._sinusoid(1500, 64, jnp.float32), rtol=1e-5, atol=1e-4)


def test_encoder_matches_the_reference():
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32")
    with use_pallas(True):
        want = jax.jit(functools.partial(
            jfactory._encode, cfg=jcfg, dtype=jnp.float32, remat=False))(
            params, batch["frames"])
    got = factory._encode(pp, pb["frames"], cfg, torch.float32)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    close(got, want)


def test_cross_attention_decode_step_matches_the_reference():
    """One query against the memory's cache: nothing is written, the
    ``memory_len`` valid slots attend (here 20 of the 32)."""
    jcfg, cfg = configs()
    p = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(2), jcfg))
    x, mem = rand(6, 2, 1, cfg.d_model), rand(7, 2, 32, cfg.d_model)
    k, v = (np.asarray(a) for a in jattn.project_kv(
        p, jnp.asarray(mem), jcfg, dtype=jnp.float32))
    tk, tv = tattn.project_kv(interop.to_tensors(p, "cpu"), t(mem), cfg,
                              dtype=torch.float32)
    close(tk, k)
    close(tv, v)
    with use_pallas(True):
        want, wk, _ = jax.jit(functools.partial(
            jattn.decode_attention, cfg=jcfg, rope=False, dtype=jnp.float32,
            cross=True, memory_len=20))(
            p, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
            jnp.int32(9))
    ck, cv = t(k), t(v)
    got, gk, _ = tattn.decode_attention(
        interop.to_tensors(p, "cpu"), t(x), ck, cv,
        torch.tensor(9, dtype=torch.int32), cfg, rope=False,
        dtype=torch.float32, cross=True,
        memory_len=torch.tensor(20, dtype=torch.int32))
    close(got, want)
    assert gk is ck and torch.equal(ck, t(k))           # no cache write


def test_grow_cache_keeps_the_memory_cache():
    jcfg, cfg = configs()
    cache = jax.tree.map(lambda a: a + 1, jfactory.init_cache(jcfg, 2, 12))
    want = jengine._grow_cache(jcfg, cache, 12 + GEN)
    got = engine._grow_cache(cfg, interop.to_tensors(
        jax.tree.map(np.asarray, cache), "cpu"), 12 + GEN)
    assert sorted(got) == ["k", "v", "xk", "xv"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name], np.float32))
    assert got["xk"].shape[2] == cfg.encoder_seq


def test_greedy_generate_matches_the_reference_f32():
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32")
    got = engine.greedy_generate(rc, pp, pb, P, GEN)
    with use_pallas(True):
        want = jengine.greedy_generate(jrc, params, batch, P, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_logits, want_toks = reference_run(jrc, params, batch, P, GEN)
    np.testing.assert_array_equal(got.numpy(), want_toks)
    assert_logits_close(port_run(rc, pp, pb, want_toks, P), want_logits,
                        1e-4)
    # the prefill's caches are the reference's
    with use_pallas(True):
        jcache, _ = jax.jit(jengine.make_prefill_step(jrc, P + GEN))(
            params, batch)
    cache, _ = engine.make_prefill_step(rc, P + GEN)(pp, pb)
    for name in ("k", "v", "xk", "xv"):
        close(cache[name], jcache[name])


def test_serving_logits_match_the_reference_bf16():
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "bfloat16")
    want_logits, want_toks = reference_run(jrc, params, batch, P, GEN)
    assert_logits_close(port_run(rc, pp, pb, want_toks, P), want_logits,
                        2e-2)


def test_decode_step_memory_len_default():
    """``decode_step`` makes the memory's valid length itself when not
    given; the engine's step function makes it once and passes it. Both
    give the reference's logits."""
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32")
    with use_pallas(True):
        jcache, jlogits = jax.jit(jengine.make_prefill_step(jrc, P + 2))(
            params, batch)
        jcache = jengine._grow_cache(jcfg, jcache, P + 2)
        tok = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
        want, _ = jax.jit(jengine.make_decode_step(jrc))(
            params, tok, jcache, jnp.int32(P))
    tok, pos = t(tok), torch.tensor(P, dtype=torch.int32)
    step = engine.make_decode_step(rc)
    for decode in (lambda c: step(pp, tok, c, pos),
                   lambda c: factory.decode_step(pp, tok, c, pos, cfg,
                                                 dtype=torch.float32)):
        cache, _ = engine.make_prefill_step(rc, P + 2)(pp, pb)
        got, _ = decode(engine._grow_cache(cfg, cache, P + 2))
        assert_logits_close(got.numpy(), np.asarray(want), 1e-4)


def test_launcher_and_example_serve_whisper_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` and the serve_decode example
    (the tokens of the chosen device against the CPU's) on the CPU."""
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--arch", "whisper-medium", "--reduced",
                          "--device", "cpu", "--batch", "2",
                          "--prompt-len", "24", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "device: cpu" in out
    assert serve_decode.main(["--arch", "whisper-medium", "--device", "cpu",
                              "--gen", "4"]) == 0
    assert "identical across devices: True" in capsys.readouterr().out


def test_count_params_analytic_matches_the_built_and_the_reference():
    """At full width: the analytic count (and its active count, the same
    for a dense stack) equals the reference's and the leaves
    ``init_params`` builds on the meta device (nothing is drawn)."""
    from repro_torch._tree import tree_leaves
    cfg = get_config("whisper-medium")
    meta = factory.init_params(cfg, torch.Generator(), device="meta")
    n = sum(a.numel() for a in tree_leaves(meta))
    assert n == cfg.param_count() == cfg.active_param_count() == \
        jfactory.count_params_analytic(jax_get_config("whisper-medium"))
