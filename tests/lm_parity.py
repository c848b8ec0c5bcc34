"""Shared helpers of the LM serving parity tests (``test_torch_moe.py``,
``test_torch_encdec.py``, ``test_torch_vlm.py``): the reference's
parameters and batch carried across through numpy, and prefill plus
greedy decode steps on both sides, the logits of each step kept.

``seq_len`` sizes both sides' caches and ``start`` is the position of
the first decode step; by default the engine's own (``P + G`` and
``P``), which the VLM overrides to count its patch prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import RunConfig as JaxRunConfig
from repro.data.tokens import make_batch as jax_make_batch
from repro.kernels.ops import use_pallas
from repro.models import factory as jfactory
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.configs.base import InputShape, RunConfig
from repro_torch.models import factory
from repro_torch.serve import engine

B = 2


def setup(jcfg, cfg, P, compute_dtype, seq=None):
    """Both run configs, the reference's parameters and batch (``P`` text
    tokens; ``seq`` the shape's length, which a VLM's patches count), and
    the port's copies of them."""
    seq = seq or P
    jrc = JaxRunConfig(model=jcfg, shape=JaxShape("s", seq, B, "prefill"),
                       compute_dtype=compute_dtype)
    rc = RunConfig(model=cfg, shape=InputShape("s", seq, B, "prefill"),
                   compute_dtype=compute_dtype)
    params = jax.jit(jfactory.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    batch = jax_make_batch(jcfg, jrc.shape, jax.random.PRNGKey(1))
    assert batch["tokens"].shape == (B, P)
    port_params = interop.to_tensors(jax.tree.map(np.asarray, params), "cpu")
    port_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jrc, rc, params, batch, port_params, port_batch


def reference_run(jrc, params, batch, P, G, pallas=True, seq_len=None,
                  start=None):
    """The reference's jitted prefill (caches of ``seq_len``) and ``G``
    greedy decode steps from position ``start``: (logits (G + 1, B, 1,
    V) float32, tokens (B, G))."""
    total = seq_len or P + G
    start = P if start is None else start
    with use_pallas(pallas):
        prefill = jax.jit(jengine.make_prefill_step(jrc, total))
        decode = jax.jit(jengine.make_decode_step(jrc))
        cache, logits = prefill(params, batch)
        cache = jengine._grow_cache(jrc.model, cache, total)
        out, toks = [logits], []
        for i in range(G):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(tok)
            logits, cache = decode(params, tok, cache, jnp.int32(start + i))
            out.append(logits)
    return (np.stack([np.asarray(x, np.float32) for x in out]),
            np.concatenate([np.asarray(x) for x in toks], 1))


def port_run(rc, params, batch, tokens, P, seq_len=None, start=None):
    """The port's prefill and decode steps fed ``tokens`` (B, G), the
    logits of each, as ``reference_run``'s."""
    G = tokens.shape[1]
    total = seq_len or P + G
    start = P if start is None else start
    params = factory.cast_params(params, engine.dtype_of(rc.compute_dtype))
    cache, logits = engine.make_prefill_step(rc, total)(params, batch)
    cache = engine._grow_cache(rc.model, cache, total)
    decode = engine.make_decode_step(rc)
    out = [logits]
    for i in range(G):
        tok = torch.from_numpy(tokens[:, i:i + 1].copy())
        logits, cache = decode(params, tok, cache,
                               torch.tensor(start + i, dtype=torch.int32))
        out.append(logits)
    return np.stack([x.float().numpy() for x in out])


def assert_logits_close(got, want, rel):
    """Within ``rel`` of the largest logit."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)
