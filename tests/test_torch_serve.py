"""The port's serving path against the JAX engine, on the CPU: whole
``greedy_generate`` runs (prefill, then batched greedy decode with the KV
cache) with the reference's parameters and prompts carried across
through numpy, against ``repro.serve.engine.greedy_generate`` on its
Pallas kernels in interpret mode (``use_pallas(True)``) and on its jnp
path (``use_pallas(False)``); the logits of the prefill and of every
decode step; and the launcher.

Configurations: reduced ``qwen2-0.5b``; a small one with qwen2's grouping
(14 heads over 2 KV heads of 64, G = 7); reduced ``h2o-danube-1.8b``
(sliding window 64) with an 80-token prompt, so the prefill rolls the
ring and every decode step writes a wrapped slot; reduced
``mamba2-130m`` (2 SSM layers) with a 64-token prompt, two chunks of 32;
reduced ``zamba2-1.2b`` at 5 layers, groups (0, 2), (2, 4), (4, 5) (the
last slice ragged), with a 64-token prompt, so the shared attention's
64-slot window ring wraps during decode; and ``mamba2-130m`` with a
20-token prompt, one ragged chunk.

Tolerances. float32 compute: logits within 1e-4 relative (of the largest
logit) of the reference's, and the tokens identical. bfloat16 compute:
the reference's two paths differ from each other (its jnp path scores in
bf16, its kernels in float32), and the port follows the kernels; every
activation is rounded to bf16 at other places by XLA and PyTorch, so the
logits agree within 2e-2 of the largest logit (0.7e-2 to 0.9e-2 on the
dense cases, 1.1e-2 on mamba2), and tokens are not compared (151,936-way
bf16 logits tie easily). Reduced zamba2 (5 SSM layers and 3 calls of
the shared block, logits below ~1.2) is held within 3e-2: bf16 rounding
alone puts the reference's own kernel path 2.6e-2 from its float32
result on the prefill, and its two paths 2.4e-2 to 4.8e-2 from each
other; the port lies 1.9e-2 to 2.3e-2 from the kernel path.
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
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import RunConfig as JaxRunConfig
from repro.data.tokens import make_batch as jax_make_batch
from repro.kernels.ops import use_pallas
from repro.models import factory as jfactory
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig, RunConfig
from repro_torch.data.tokens import make_batch
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.launch import serve as launcher
from repro_torch.models import factory
from repro_torch.serve import engine

torch.set_num_threads(2)

G7 = dict(name="g7", family="dense", num_layers=2, d_model=128,
          num_heads=14, num_kv_heads=2, head_dim=64, d_ff=256,
          vocab_size=512, qkv_bias=True, rope_theta=1e6,
          tie_embeddings=True)

# name -> (reference config, port config, prompt length, new tokens)
CASES = {
    "qwen2-0.5b": (jax_get_config("qwen2-0.5b").reduced(),
                   get_config("qwen2-0.5b").reduced(), 16, 6),
    "g7": (JaxConfig(**G7), ModelConfig(**G7), 24, 5),
    "h2o-danube-1.8b": (jax_get_config("h2o-danube-1.8b").reduced(),
                        get_config("h2o-danube-1.8b").reduced(), 80, 6),
    "mamba2-130m": (jax_get_config("mamba2-130m").reduced(),
                    get_config("mamba2-130m").reduced(), 64, 6),
    "mamba2-130m-one-chunk": (jax_get_config("mamba2-130m").reduced(),
                              get_config("mamba2-130m").reduced(), 20, 5),
    "zamba2-1.2b": (jax_get_config("zamba2-1.2b").reduced(num_layers=5),
                    get_config("zamba2-1.2b").reduced(num_layers=5), 64, 6),
}
B = 2
BF16_TOL = {"zamba2-1.2b": 3e-2}    # the others: 2e-2


def setup(name, compute_dtype):
    """Both run configs, the reference's parameters and prompts, and the
    port's copies of them."""
    jcfg, cfg, P, G = CASES[name]
    jrc = JaxRunConfig(model=jcfg, shape=JaxShape("s", P, B, "prefill"),
                       compute_dtype=compute_dtype)
    rc = RunConfig(model=cfg, shape=InputShape("s", P, B, "prefill"),
                   compute_dtype=compute_dtype)
    params = jax.jit(jfactory.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    batch = jax_make_batch(jcfg, jrc.shape, jax.random.PRNGKey(1))
    port_params = interop.to_tensors(jax.tree.map(np.asarray, params),
                                        "cpu")
    port_batch = {"tokens": torch.from_numpy(np.array(batch["tokens"]))}
    return jrc, rc, params, batch, port_params, port_batch, P, G


def reference_logits(jrc, params, batch, P, G, pallas):
    """The reference engine's prefill and decode steps (jit), the logits
    of each, and its greedy tokens."""
    total = P + G
    with use_pallas(pallas):
        prefill = jax.jit(jengine.make_prefill_step(jrc, total))
        decode = jax.jit(jengine.make_decode_step(jrc))
        cache, logits = prefill(params, batch)
        cache = jengine._grow_cache(jrc.model, cache, total)
        out, toks = [logits], []
        for i in range(G):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(tok)
            logits, cache = decode(params, tok, cache, jnp.int32(P + i))
            out.append(logits)
    return (np.stack([np.asarray(x, np.float32) for x in out]),
            np.concatenate([np.asarray(x) for x in toks], 1))


def port_logits(rc, params, batch, tokens, P):
    """The port's prefill and decode steps fed the reference's tokens,
    the logits of each."""
    G = tokens.shape[1]
    params = factory.cast_params(params, engine.dtype_of(rc.compute_dtype))
    cache, logits = engine.make_prefill_step(rc, P + G)(params, batch)
    cache = engine._grow_cache(rc.model, cache, P + G)
    decode = engine.make_decode_step(rc)
    out = [logits]
    for i in range(G):
        tok = torch.from_numpy(tokens[:, i:i + 1].copy())
        logits, cache = decode(params, tok, cache,
                               torch.tensor(P + i, dtype=torch.int32))
        out.append(logits)
    return np.stack([x.float().numpy() for x in out])


def assert_logits_close(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_generate_matches_the_reference_f32(name):
    jrc, rc, params, batch, pp, pb, P, G = setup(name, "float32")
    got = engine.greedy_generate(rc, pp, pb, P, G)
    assert got.dtype == torch.int32 and got.shape == (B, G)
    for pallas in (True, False):
        with use_pallas(pallas):
            want = jengine.greedy_generate(jrc, params, batch, P, G)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"use_pallas({pallas})")
    want_logits, want_toks = reference_logits(jrc, params, batch, P, G,
                                              pallas=True)
    np.testing.assert_array_equal(got.numpy(), want_toks)
    assert_logits_close(port_logits(rc, pp, pb, want_toks, P), want_logits,
                        1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_logits_match_the_reference_bf16(name):
    jrc, rc, params, batch, pp, pb, P, G = setup(name, "bfloat16")
    want_logits, want_toks = reference_logits(jrc, params, batch, P, G,
                                              pallas=True)
    got = port_logits(rc, pp, pb, want_toks, P)
    assert_logits_close(got, want_logits, BF16_TOL.get(name, 2e-2))
    # the prefill's cache stays in the compute dtype, as the reference's
    cache, _ = engine.make_prefill_step(rc, P + G)(
        factory.cast_params(pp, torch.bfloat16), pb)
    assert all(a.dtype == torch.bfloat16 for a in tree_leaves(cache))


def test_grow_cache_matches_the_reference():
    for name in ("qwen2-0.5b", "h2o-danube-1.8b"):
        jcfg, cfg, P, G = CASES[name]
        cache = jfactory.init_cache(jcfg, B, P)
        cache = jax.tree.map(lambda a: a + 1, cache)
        want = jengine._grow_cache(jcfg, cache, P + G)
        got = engine._grow_cache(cfg, interop.to_tensors(
            jax.tree.map(np.asarray, cache), "cpu"), P + G)
        for k in ("k", "v"):
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


def count_model_op_calls(cfg, prompt, gen):
    """greedy_generate on the CPU with every model op wrapped to count its
    calls and to assert that each tensor it is handed is contiguous, as
    the CUDA kernels require. -> (calls, tokens)."""
    rc = RunConfig(model=cfg, shape=InputShape("s", prompt, B, "prefill"),
                   compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, rc.shape, torch.Generator().manual_seed(1))
    calls = {}

    def counting(fn, name):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            assert all(x.is_contiguous() for x in a
                       if isinstance(x, torch.Tensor)), name
            return fn(*a, **kw)
        return wrapper

    from repro_torch.kernels import ops
    LAUNCH_COUNTS.clear()
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        for name in ("rmsnorm", "rope", "flash_attention",
                     "decode_attention", "ssd_scan"):
            m.setattr(ops, name, counting(getattr(ops, name), name))
        toks = engine.greedy_generate(rc, params, batch, prompt, gen)
    assert sum(LAUNCH_COUNTS.values()) == 0
    assert toks.shape == (B, gen)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    return calls, toks


def test_greedy_generate_counts_the_kernel_calls_per_step():
    """On the CPU the plain versions run and no kernel launches; the
    number of model-op calls per prefill and decode step is what the
    card's launch counts assert (chip_smoke.py): 2L + 1 norms, L ropes,
    L flash and L decode attentions. Every tensor the path hands them is
    contiguous, as the CUDA kernels require."""
    cfg = get_config("qwen2-0.5b").reduced()
    calls, toks = count_model_op_calls(cfg, 8, 3)
    L = cfg.num_layers
    assert calls == {"rmsnorm": (2 * L + 1) * 4, "rope": L * 4,
                     "flash_attention": L, "decode_attention": L * 3}


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 2),
                                         ("zamba2-1.2b", 5)])
def test_greedy_generate_counts_the_ssd_scan_and_norm_calls(arch, layers):
    """ssm: per forward, L pre-norms, L gated norms and ln_f; L scans in
    the prefill only. hybrid: the same for its L core layers, plus two
    norms, one rope, one flash attention (prefill) or one decode attention
    (each step) per shared-block call, one call per group. At full width that
    is chip_smoke.py's 49 x 65 = 3185 and 91 x 65 = 5915 norms."""
    cfg = get_config(arch).reduced(num_layers=layers)
    calls, _ = count_model_op_calls(cfg, 32, 3)
    L = cfg.num_layers
    n_inv = len(factory._hybrid_groups(cfg)) if arch == "zamba2-1.2b" else 0
    want = {"rmsnorm": (2 * L + 1 + 2 * n_inv) * 4, "ssd_scan": L}
    if n_inv:
        want.update(rope=n_inv * 4, flash_attention=n_inv,
                    decode_attention=n_inv * 3)
    assert calls == want
    full = get_config(arch)
    g = len(factory._hybrid_groups(full)) if arch == "zamba2-1.2b" else 0
    assert (2 * full.num_layers + 1 + 2 * g) * 65 == \
        {"mamba2-130m": 3185, "zamba2-1.2b": 5915}[arch]


def test_grow_cache_pads_only_attention_caches_like_the_reference():
    """The hybrid's {"core", "shared"} cache: the shared k/v grow to the
    horizon, the SSM states stay as they are; the ssm cache is left
    alone."""
    for name in ("zamba2-1.2b", "mamba2-130m"):
        jcfg, cfg, P, G = CASES[name]
        cache = jfactory.init_cache(jcfg, B, 20)
        cache = jax.tree.map(lambda a: a + 1, cache)
        want = jengine._grow_cache(jcfg, cache, 20 + G)
        got = engine._grow_cache(cfg, interop.to_tensors(
            jax.tree.map(np.asarray, cache), "cpu"), 20 + G)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda x: x, got,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, g), (_, w) in zip(flat_g, flat_w):
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


def test_make_batch_draws_tokens_from_the_generator():
    cfg = get_config("qwen2-0.5b").reduced()
    shape = InputShape("s", 12, 3, "prefill")
    a = make_batch(cfg, shape, torch.Generator().manual_seed(5))
    b = make_batch(cfg, shape, torch.Generator().manual_seed(5))
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (3, 12)
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < cfg.vocab_size
    # the VLM reserves its patch prefix inside seq_len and draws patches
    # after the tokens (tests/test_torch_vlm.py holds the rest)
    vlm = dataclasses.replace(cfg, family="vlm", num_patch_tokens=4)
    c = make_batch(vlm, shape, torch.Generator().manual_seed(5))
    assert c["tokens"].shape == (3, 8) and c["patches"].shape == (3, 4, 256)
    d = make_batch(vlm, shape, torch.Generator().manual_seed(5))
    assert all(torch.equal(c[k], d[k]) for k in ("tokens", "patches"))


def test_launcher_serves_on_the_cpu(capsys):
    assert launcher.main(["--arch", "h2o-danube-1.8b", "--reduced",
                          "--device", "cpu", "--batch", "2",
                          "--prompt-len", "70", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "tok/s" in out
    assert "device: cpu" in out


@pytest.mark.parametrize("arch,prompt", [("mamba2-130m", 64),
                                         ("zamba2-1.2b", 32)])
def test_launcher_serves_ssm_and_hybrid_on_the_cpu(capsys, arch, prompt):
    assert launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", str(prompt),
                          "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "device: cpu" in out
