"""The backward of the port's rmsnorm and flash attention on the CPU.

The plain backward versions (``rmsnorm_bwd_ref``, ``flash_attention_bwd_ref``:
explicit formulas, not autograd) against ``jax.vjp`` of the JAX
package's oracles (``repro/kernels/ref.py`` ``rmsnorm_ref`` and
``attention_ref``; for the prefix mask, which ``ref.py`` lacks, the
reference model's jnp attention path, ``make_mask`` +
``_gqa_scores_to_out``) and against torch autograd through the port's
plain forwards, in float32 on numpy-seeded inputs; and the
``autograd.Function``s the ops dispatch to. Tolerance: 2e-5 of the
largest gradient value (float32 sums over the sequence and the heads of
a group, taken in another order by each side).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms

torch.set_num_threads(2)

REL = 2e-5


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 96), (7, 33)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    jdx, jdw = jax.jit(lambda a, b, g: jax.vjp(jref.rmsnorm_ref, a, b)[1](g))(
        x, w, dy)
    dx, dw = rms.rmsnorm_bwd_ref(t(x), t(w), t(dy))
    close(dx, jdx)
    close(dw, jdw)
    # and against autograd through the plain forward
    xs, ws = t(x).requires_grad_(), t(w).requires_grad_()
    ax, aw = torch.autograd.grad(rms.rmsnorm_ref(xs, ws), (xs, ws), t(dy))
    close(dx, ax)
    close(dw, aw)


def test_rmsnorm_function_on_the_cpu():
    """``ops.rmsnorm`` under autograd goes through ``RMSNorm`` (the plain
    backward on the CPU); without a gradient it is the plain forward."""
    rng = np.random.default_rng(0)
    x = t(rng.standard_normal((3, 5, 32))).requires_grad_()
    w = t(rng.standard_normal(32)).requires_grad_()
    y = ops.rmsnorm(x, w)
    assert y.grad_fn is not None and "RMSNorm" in type(y.grad_fn).__name__
    dy = t(rng.standard_normal((3, 5, 32)))
    got = torch.autograd.grad(y, (x, w), dy)
    want = rms.rmsnorm_bwd_ref(x.detach(), w.detach(), dy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert ops.rmsnorm(x, w).grad_fn is None


def _jax_attention(q, k, v, causal, window, prefix):
    if prefix is None:
        return jref.attention_ref(q, k, v, causal=causal, window=window)
    # the reference model's jnp path: make_mask with the prefix
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    mask = jattn.make_mask(jnp.arange(Sk - Sq, Sk), jnp.arange(Sk),
                           causal=causal, window=window,
                           prefix_len=prefix)[None, None, None]
    return jattn._gqa_scores_to_out(q, k, v, mask, None).reshape(q.shape)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_vjp(q, k, v, dout, causal, window, prefix):
    out, vjp = jax.vjp(
        lambda a, b, c: _jax_attention(a, b, c, causal, window, prefix),
        q, k, v)
    return out, vjp(dout)


# (B, Sq, Sk, H, KV, d, causal, window, prefix): every query row sees at
# least one key (the reference's softmax averages a keyless row)
ATTN_CASES = [
    (2, 16, 16, 4, 4, 16, True, None, None),     # causal, G 1
    (1, 24, 24, 4, 2, 32, True, None, None),     # causal, G 2
    (1, 20, 20, 7, 1, 16, True, None, None),     # causal, G 7
    (2, 12, 30, 4, 2, 16, True, None, None),     # q at the end of k
    (1, 32, 32, 4, 2, 16, True, 8, None),        # window
    (1, 24, 24, 7, 1, 16, True, 5, None),        # window, G 7
    (1, 20, 20, 4, 2, 16, True, None, 6),        # prefix
    (1, 20, 20, 4, 1, 32, True, 4, 9),           # prefix and window
    (2, 18, 18, 4, 2, 16, False, None, None),    # non-causal
    (1, 10, 26, 4, 2, 16, False, None, None),    # cross (Sq != Sk)
    (1, 26, 10, 7, 1, 16, False, None, None),    # cross, G 7
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal,window,prefix", ATTN_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(B, Sq, Sk, H, KV, d, causal,
                                                 window, prefix):
    rng = np.random.default_rng(Sq * 100 + Sk + H + d)
    q, dout = (rng.standard_normal((B, Sq, H, d)).astype(np.float32)
               for _ in "ab")
    k, v = (rng.standard_normal((B, Sk, KV, d)).astype(np.float32)
            for _ in "ab")
    jout, jgrads = _jax_vjp(q, k, v, dout, causal, window, prefix)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = fa.attention_ref(t(q), t(k), t(v), return_lse=True, **kw)
    close(out, jout)
    assert bool(torch.isfinite(lse).all())
    grads = fa.flash_attention_bwd_ref(t(q), t(k), t(v), out, lse, t(dout),
                                       **kw)
    for got, want in zip(grads, jgrads):
        close(got, want)
    # against autograd through the port's plain forward
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(fa.attention_ref(*ts, **kw), ts, t(dout))
    for got, want in zip(grads, auto):
        close(got, want)
    # the Function ops dispatches to on a tensor that needs a gradient
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    y = ops.flash_attention(*ts, **kw)
    assert "FlashAttention" in type(y.grad_fn).__name__
    for got, want in zip(torch.autograd.grad(y, ts, t(dout)), grads):
        assert torch.equal(got, want)


def test_keyless_rows_give_zero_gradients():
    """Sq > Sk under the causal mask: the first rows see no key. Their
    LSE is -inf, their output and gradients zero, and nothing is NaN."""
    rng = np.random.default_rng(1)
    q, dout = (t(rng.standard_normal((1, 9, 4, 16))) for _ in "ab")
    k, v = (t(rng.standard_normal((1, 5, 2, 16))) for _ in "ab")
    out, lse = fa.attention_ref(q, k, v, return_lse=True)
    assert bool(torch.isneginf(lse[..., :4]).all())
    assert bool(torch.isfinite(lse[..., 4:]).all())
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert bool((dq[:, :4] == 0).all()) and bool((out[:, :4] == 0).all())


def test_bf16_plain_backward_returns_the_operands_dtype():
    rng = np.random.default_rng(2)
    q = t(rng.standard_normal((1, 8, 2, 16))).bfloat16()
    k = t(rng.standard_normal((1, 8, 1, 16))).bfloat16()
    out, lse = fa.attention_ref(q, k, k, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = fa.flash_attention_bwd_ref(q, k, k, out, lse, out)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    x = t(rng.standard_normal((4, 16))).bfloat16()
    dx, dw = rms.rmsnorm_bwd_ref(x, torch.ones(16), x)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


def test_decode_attention_refuses_a_gradient():
    """No training path runs it, so it has no backward kernel: a call
    that needs a gradient raises on either device (here the CPU), and
    passes under no_grad. (The SSD scan trains: tests/test_torch_ssd_grads.py.)"""
    q = torch.randn((1, 4, 8), requires_grad=True)
    kv = torch.randn((1, 6, 2, 8))
    with pytest.raises(ValueError, match="decode_attention"):
        ops.decode_attention(q, kv, kv, torch.tensor(6))
    with torch.no_grad():
        ops.decode_attention(q, kv, kv, torch.tensor(6))
