"""The LM model kernels' plain versions against the JAX package: each of
``rmsnorm_ref``, ``attention_ref`` and ``decode_attention_ref`` (what the
port runs on a CPU tensor, and what ``chip_smoke.py`` holds the CUDA
kernels against on the card) is held against the JAX Pallas kernel in
interpret mode and against its ``repro/kernels/ref.py`` oracle, on the
same numpy inputs made from a seed.

Tolerances: float32, 2e-5 absolute (the reduction orders differ: XLA's
blocked online softmax against PyTorch's einsum and softmax); bfloat16,
one bf16 rounding step (2**-7 relative) of the reference plus the same
float32 allowance, since both sides compute in float32 and round once.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_ref

torch.set_num_threads(2)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def inputs(seed, dtype, *shapes):
    """Normal draws made with numpy and rounded once to ``dtype``: the
    same bits for both frameworks."""
    rng = np.random.default_rng(seed)
    np_dt, _, _ = DTYPES[dtype]
    return [rng.standard_normal(s, dtype=np.float32).astype(np_dt)
            for s in shapes]


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, dtype):
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 64), (2, 5, 7, 128),
                                   (1, 256), (8, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_oracle(shape, dtype):
    x, = inputs(sum(shape), dtype, shape)
    w, = inputs(sum(shape) + 1, "float32", shape[-1:])
    got = rmsnorm_ref(to_torch(x), to_torch(w), eps=1e-6)
    assert got.dtype == DTYPES[dtype][2] and got.shape == shape
    assert_close(got, jax_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                  block_rows=8), dtype)
    assert_close(got, jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w)),
                 dtype)
    # kernels.ops sends a CPU tensor to the plain version
    assert torch.equal(kops.rmsnorm(to_torch(x), to_torch(w)), got)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal,window", [
    (2, 64, 64, 4, 2, 32, True, None),     # GQA 2:1
    (1, 48, 48, 3, 1, 16, True, None),     # MQA, odd sizes
    (1, 40, 40, 2, 1, 8, True, None),      # S not a block multiple
    (1, 72, 72, 15, 5, 64, True, None),    # smollm-like 15h/5kv
    (1, 40, 40, 14, 2, 64, True, None),    # qwen2-like G = 7, d = 64
    (1, 24, 56, 14, 2, 64, True, None),    # Sq < Sk: q at the end of k
    (1, 96, 96, 4, 2, 16, True, 8),        # sliding windows
    (1, 96, 96, 4, 2, 16, True, 32),
    (2, 33, 33, 2, 2, 8, False, None),     # non-causal
    (1, 40, 40, 4, 2, 16, False, 12),      # window without causality
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_pallas_and_oracle(B, Sq, Sk, H, KV, d,
                                                   causal, window, dtype):
    q, k, v = inputs(Sq * H + d, dtype, (B, Sq, H, d), (B, Sk, KV, d),
                     (B, Sk, KV, d))
    kw = dict(causal=causal, window=window)
    got = attention_ref(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert got.dtype == DTYPES[dtype][2] and got.shape == (B, Sq, H, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert_close(got, jax_flash(jq, jk, jv, block_q=16, block_k=16, **kw),
                 dtype)
    assert_close(got, jref.attention_ref(jq, jk, jv, **kw), dtype)
    assert torch.equal(kops.flash_attention(to_torch(q), to_torch(k),
                                            to_torch(v), **kw), got)


def test_attention_plain_rows_without_keys_are_zero():
    """Sq > Sk under the causal mask: the first rows see no key. The
    Pallas kernel's finite -1e30, its ``p = where(mask, p, 0)`` and its
    normaliser floor give zeros there, not NaN, and so does the plain
    version. (``ref.py``'s oracle, a softmax alone, averages the masked
    values on such rows instead; it agrees on every row with a key.)"""
    q, k, v = inputs(3, "float32", (1, 20, 2, 8), (1, 12, 1, 8),
                     (1, 12, 1, 8))
    got = attention_ref(to_torch(q), to_torch(k), to_torch(v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert_close(got, jax_flash(jq, jk, jv, block_q=8, block_k=8),
                 "float32")
    assert not got[0, :8].any() and bool(torch.isfinite(got).all())
    assert_close(got[:, 8:], jref.attention_ref(jq, jk, jv)[:, 8:],
                 "float32")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KV,d,vl", [
    (2, 128, 4, 2, 32, 128),
    (1, 100, 3, 1, 16, 77),     # partial cache, odd length
    (2, 96, 14, 2, 64, 70),     # qwen2-like G = 7, d = 64
    (1, 64, 2, 2, 8, 1),        # first decode step
    (1, 96, 15, 5, 32, 50),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_and_oracle(B, S, H, KV, d,
                                                          vl, dtype):
    q, k, v = inputs(S + vl, dtype, (B, H, d), (B, S, KV, d),
                     (B, S, KV, d))
    valid = torch.tensor(vl, dtype=torch.int32)
    got = decode_attention_ref(to_torch(q), to_torch(k), to_torch(v), valid)
    assert got.dtype == DTYPES[dtype][2] and got.shape == (B, H, d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert_close(got, jax_decode(jq, jk, jv, vl, block_k=32), dtype)
    assert_close(got, jref.decode_attention_ref(jq, jk, jv, vl), dtype)
    assert torch.equal(kops.decode_attention(to_torch(q), to_torch(k),
                                             to_torch(v), valid), got)


def test_decode_attention_plain_clamps_valid_len_like_pallas():
    """valid_len past the cache: the Pallas wrapper clamps it to S; the
    plain version's mask covers every slot, the same thing."""
    q, k, v = inputs(5, "float32", (1, 4, 16), (1, 40, 2, 16),
                     (1, 40, 2, 16))
    got = decode_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                               torch.tensor(75, dtype=torch.int32))
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 75,
                      block_k=16)
    assert_close(got, want, "float32")


def test_decode_attention_plain_with_no_valid_slot_is_zero():
    """valid_len 0: zeros, as in the Pallas kernel."""
    q, k, v = inputs(6, "float32", (2, 4, 16), (2, 40, 2, 16),
                     (2, 40, 2, 16))
    got = decode_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                               torch.tensor(0, dtype=torch.int32))
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0,
                      block_k=16)
    assert_close(got, want, "float32")
    assert not got.any()
