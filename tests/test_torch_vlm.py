"""The port's VLM family (paligemma) against the JAX package, on the CPU:
the prefix mask of ``attention_ref`` (every query sees the keys below
``prefix_len``, causal masking otherwise) against the reference's
``make_mask``; the prefix prefill of reduced ``paligemma-3b`` (16 patch
embeddings before 8 text tokens), which the reference always runs on its
jnp masked path; and greedy decode after it.

The reference's VLM ``greedy_generate`` is no oracle: it sizes the
caches from ``prompt_len + num_tokens`` and leaves out the patches, so
its prefill keeps only the last keys (``to_ring``) and its decode writes
past the cache (ROADMAP.md, "Reference paths that are red"). The port's
decode is held against the reference's ``prefill`` and ``decode_step``
called with a ``seq_len`` that counts the patches, from position
``num_patch_tokens + prompt_len``; a test shows both caches.

Tolerances. float32 compute: the masked attention within 1e-5 relative
and 2e-5 absolute; the serving logits within 1e-4 of the largest logit
and the greedy tokens identical. bfloat16 compute: the logits within
2e-2 of the largest, as ``test_torch_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.tokens import make_batch, text_len
from repro_torch.kernels import flash_attention as fa
from repro_torch.serve import engine

from lm_parity import (assert_logits_close, port_run, reference_run,
                       setup)

torch.set_num_threads(2)

ARCH = "paligemma-3b"
P, GEN = 8, 4
NP = 16                            # the reduced config's patch tokens
TOTAL = NP + P + GEN               # the caches' slots


def configs():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert cfg.num_patch_tokens == NP
    return jcfg, cfg


@pytest.mark.parametrize("Sq,Sk,prefix,window", [
    (24, 24, 16, None),          # the reduced prefill
    (40, 40, 7, None),           # a prefix that ends mid-row
    (30, 30, 30, None),          # all prefix: no causal mask left
    (30, 30, 0, None),           # no prefix: causal
    (36, 36, 12, 8),             # a window hides old prefix keys too
])
def test_attention_prefix_mask_matches_make_mask(Sq, Sk, prefix, window):
    rng = np.random.default_rng(Sq + prefix)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    pos = jnp.arange(Sk)
    mask = jattn.make_mask(pos[Sk - Sq:], pos, causal=True, window=window,
                           prefix_len=prefix)[None, None, None]
    want = jattn._gqa_scores_to_out(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask, None)
    got = fa.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window,
                           prefix_len=prefix)
    np.testing.assert_allclose(got.reshape(2, Sq, -1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=2e-5)


def test_make_batch_draws_patches_and_reserves_the_prefix():
    cfg = get_config(ARCH).reduced()
    shape = InputShape("s", NP + P, 3, "prefill")
    a = make_batch(cfg, shape, torch.Generator().manual_seed(2))
    b = make_batch(cfg, shape, torch.Generator().manual_seed(2))
    assert text_len(cfg, NP + P) == P
    assert a["tokens"].shape == (3, P) and a["tokens"].dtype == torch.int32
    assert a["patches"].shape == (3, NP, cfg.d_model)
    assert a["patches"].dtype == torch.float32
    assert all(torch.equal(a[key], b[key]) for key in a)


def test_prefill_caches_count_the_patches_unlike_the_reference():
    """The reference's greedy_generate prefills with seq_len = prompt +
    new tokens = 12: its caches keep 12 slots, the last 12 keys of the
    24-token prefix and prompt. The port's hold 28 slots, 24 of them
    filled by the prefill, equal to the reference's prefill called with
    a seq_len that counts the patches."""
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32",
                                           seq=NP + P)
    short, _ = jax.jit(jengine.make_prefill_step(jrc, P + GEN))(params,
                                                                batch)
    full, _ = jax.jit(jengine.make_prefill_step(jrc, TOTAL))(params, batch)
    assert short["k"].shape[2] == P + GEN == 12
    assert full["k"].shape[2] == NP + P == 24
    cache, _ = engine.make_prefill_step(rc, TOTAL)(pp, pb)
    assert cache["k"].shape[2] == 24
    grown = engine._grow_cache(cfg, cache, TOTAL)
    assert grown["k"].shape[2] == 28
    assert not bool(grown["k"][:, :, 24:].any())
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(full[name]),
                                   rtol=1e-5, atol=2e-5)
        # the reference's short cache: only tokens 12..23, the patches gone
        np.testing.assert_allclose(cache[name][:, :, 12:].numpy(),
                                   np.asarray(short[name]), rtol=1e-5,
                                   atol=2e-5)


def test_greedy_generate_matches_the_reference_prefill_and_decode_f32():
    """Tokens and logits against the reference's prefill (seq_len 28, the
    jnp masked path: its Pallas flash takes no prefix) and its decode
    steps from position 24 (on its decode kernel in interpret mode)."""
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "float32",
                                           seq=NP + P)
    got = engine.greedy_generate(rc, pp, pb, P, GEN)
    want_logits, want_toks = reference_run(
        jrc, params, batch, P, GEN, seq_len=TOTAL, start=NP + P)
    np.testing.assert_array_equal(got.numpy(), want_toks)
    assert_logits_close(
        port_run(rc, pp, pb, want_toks, P, seq_len=TOTAL, start=NP + P),
        want_logits, 1e-4)


def test_serving_logits_match_the_reference_bf16():
    jcfg, cfg = configs()
    jrc, rc, params, batch, pp, pb = setup(jcfg, cfg, P, "bfloat16",
                                           seq=NP + P)
    want_logits, want_toks = reference_run(
        jrc, params, batch, P, GEN, seq_len=TOTAL, start=NP + P)
    got = port_run(rc, pp, pb, want_toks, P, seq_len=TOTAL, start=NP + P)
    assert_logits_close(got, want_logits, 2e-2)


def test_launcher_and_example_serve_paligemma_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` and the serve_decode example
    (the tokens of the chosen device against the CPU's) on the CPU."""
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve as launcher
    assert launcher.main(["--arch", "paligemma-3b", "--reduced",
                          "--device", "cpu", "--batch", "2",
                          "--prompt-len", "24", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "device: cpu" in out
    assert serve_decode.main(["--arch", "paligemma-3b", "--device", "cpu",
                              "--gen", "4"]) == 0
    assert "identical across devices: True" in capsys.readouterr().out


def test_count_params_analytic_matches_the_built_and_the_reference():
    """At full width: the analytic count (and its active count, the same
    for a dense stack) equals the reference's and the leaves
    ``init_params`` builds on the meta device (nothing is drawn)."""
    from repro.models import factory as jfactory
    from repro_torch._tree import tree_leaves
    from repro_torch.models import factory as tfactory
    cfg = get_config("paligemma-3b")
    meta = tfactory.init_params(cfg, torch.Generator(), device="meta")
    n = sum(a.numel() for a in tree_leaves(meta))
    assert n == cfg.param_count() == cfg.active_param_count() == \
        jfactory.count_params_analytic(jax_get_config("paligemma-3b"))
