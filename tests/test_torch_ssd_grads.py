"""The backward of the port's SSD scan on the CPU, and its initial state.

``ssd_scan_bwd_ref`` (the plain backward: the formulas written out, not
autograd) against ``jax.vjp`` of the JAX package's oracle
``repro/kernels/ref.py:ssd_ref``, with and without an initial state and
with the final state's cotangent zero or given, at shapes of several
chunks, one ragged chunk (S = L = 80, not a multiple of the kernel's
64-row tiles) and P, N that are not multiples of 16; against ``jax.vjp``
of the reference model's ``ssd_chunked`` over several chunks; the
forward's initial state and its chunk-start states against the oracle;
``SSDScan`` through ``kernels.ops.ssd_scan`` against torch autograd
through the plain forward; and the wrappers' refusals. Inputs are made
with numpy from a seed; the JAX side runs under ``jax.jit``.

Tolerances (float32): each gradient within 2e-5 of its largest value
(sums over the chunk, the state and the chunks, taken in other orders
by each side; measured: 1.3e-6 at most); the forward within 2e-4
absolute, ``tests/test_torch_ssd_scan.py``'s limit.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd

torch.set_num_threads(2)

REL = 2e-5
NAMES = ("dx", "ddtA", "dB", "dC", "dinitial")


def close(got, want, rel=REL, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def inputs(seed, B, S, H, P, N):
    """x, B_, C_ ~ 0.5 N(0, 1), dtA = -0.3 softplus(N(0, 1)) (the decays
    of test_kernels.py's sweep), a start state ~ 0.5 N(0, 1), dy and
    dfinal ~ N(0, 1), all float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)) * 0.5
    dtA = -np.logaddexp(rng.standard_normal((B, S, H)), 0.0) * 0.3
    Bm = rng.standard_normal((B, S, H, N)) * 0.5
    Cm = rng.standard_normal((B, S, H, N)) * 0.5
    s0 = rng.standard_normal((B, H, P, N)) * 0.5
    dy = rng.standard_normal((B, S, H, P))
    dfin = rng.standard_normal((B, H, P, N))
    return [a.astype(np.float32) for a in (x, dtA, Bm, Cm, s0, dy, dfin)]


@functools.lru_cache(maxsize=None)
def _oracle_vjp(init: bool):
    def f(x, dtA, Bm, Cm, s0, dy, dfin):
        def scan(*a):
            return jref.ssd_ref(*a[:4], a[4] if init else None)
        _, vjp = jax.vjp(scan, x, dtA, Bm, Cm, s0)
        return vjp((dy, dfin))
    return jax.jit(f)


# (B, S, H, P, N, chunk)
SHAPES = [
    (2, 64, 3, 8, 16, 16),        # four chunks
    (1, 96, 2, 24, 20, 32),       # P, N not multiples of 16, three chunks
    (2, 80, 2, 32, 32, 256),      # one ragged chunk: L = min(256, 80)
    (1, 128, 2, 64, 32, 64),      # two chunks of one 64-row tile
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("init,dfinal", [(False, False), (True, True),
                                         (True, False), (False, True)])
def test_ssd_scan_bwd_ref_matches_jax_vjp(B, S, H, P, N, chunk, init,
                                          dfinal):
    x, dtA, Bm, Cm, s0, dy, dfin = inputs(S * H + N, B, S, H, P, N)
    if not dfinal:
        dfin = np.zeros_like(dfin)
    want = _oracle_vjp(init)(x, dtA, Bm, Cm, s0, dy, dfin)
    _, _, states = tssd.ssd_scan_ref(t(x), t(dtA), t(Bm), t(Cm),
                                     chunk=chunk,
                                     initial_state=t(s0) if init else None,
                                     return_states=True)
    got = tssd.ssd_scan_bwd_ref(t(x), t(dtA), t(Bm), t(Cm), states, t(dy),
                                t(dfin) if dfinal else None, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        if name == "dinitial" and not init:
            continue          # the oracle's state is unused without init
        close(g, w, name=name)


def test_ssd_scan_bwd_ref_matches_vjp_of_ssd_chunked():
    """Against the reference model's jnp scan (the path the JAX package
    trains through) over four chunks, dfinal given."""
    B, S, H, P, N, chunk = 2, 128, 2, 16, 8, 32
    x, dtA, Bm, Cm, _, dy, dfin = inputs(11, B, S, H, P, N)
    want = jax.jit(lambda *a: jax.vjp(
        lambda *b: jssm.ssd_chunked(*b, chunk), *a[:4])[1]((a[4], a[5])))(
            x, dtA, Bm, Cm, dy, dfin)
    _, _, states = tssd.ssd_scan_ref(t(x), t(dtA), t(Bm), t(Cm), chunk=chunk,
                                     return_states=True)
    got = tssd.ssd_scan_bwd_ref(t(x), t(dtA), t(Bm), t(Cm), states, t(dy),
                                t(dfin), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        close(g, w, name=name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES[:3])
def test_ssd_scan_ref_from_an_initial_state_matches_the_oracle(B, S, H, P,
                                                               N, chunk):
    """y and the final state from a start state against ``ssd_ref``; the
    chunk-start states: the start state, then the scan's state at each
    chunk boundary (the final state of the prefix)."""
    x, dtA, Bm, Cm, s0 = inputs(S + N, B, S, H, P, N)[:5]
    y, fin, states = tssd.ssd_scan_ref(t(x), t(dtA), t(Bm), t(Cm),
                                       chunk=chunk, initial_state=t(s0),
                                       return_states=True)
    wy, wfin = jref.ssd_ref(x, dtA, Bm, Cm, s0)
    np.testing.assert_allclose(y.numpy(), wy, rtol=0, atol=2e-4)
    np.testing.assert_allclose(fin.numpy(), wfin, rtol=0, atol=2e-4)
    L = min(chunk, S)
    assert states.shape == (B, H, S // L, P, N)
    assert states.dtype == torch.float32
    np.testing.assert_array_equal(states[:, :, 0].numpy(), s0)
    for c in range(1, S // L):
        _, wpre = jref.ssd_ref(x[:, :c * L], dtA[:, :c * L], Bm[:, :c * L],
                               Cm[:, :c * L], s0)
        np.testing.assert_allclose(states[:, :, c].numpy(), wpre, rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("init,use_final", [(True, True), (False, False),
                                            (True, False)])
def test_ssd_function_on_the_cpu(init, use_final):
    """``ops.ssd_scan`` under a gradient goes through ``SSDScan``: its
    gradients (the initial state's only when one is given) against
    autograd through the plain forward; an unused final state costs no
    cotangent."""
    B, S, H, P, N, chunk = 2, 96, 2, 12, 8, 32
    arrays = inputs(3, B, S, H, P, N)
    dy, dfin = t(arrays[5]), t(arrays[6])

    def run(fn):
        leaves = [t(a).requires_grad_() for a in arrays[:5]]
        y, fin = fn(*leaves[:4], chunk=chunk,
                    initial_state=leaves[4] if init else None)
        loss = (y * dy).sum() + ((fin * dfin).sum() if use_final else 0.0)
        loss.backward()
        return y, fin, [a.grad for a in leaves]

    LAUNCH_COUNTS.clear()
    y, fin, got = run(ops.ssd_scan)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    wy, wfin, want = run(tssd.ssd_scan_ref)
    assert torch.equal(y, wy) and torch.equal(fin, wfin)
    for name, g, w in zip(NAMES, got, want):
        if name == "dinitial" and not init:
            assert g is None and w is None
            continue
        close(g, w, name=name)
    assert sum(LAUNCH_COUNTS.values()) == 0       # the plain versions


def test_ssd_scan_serving_call_takes_no_gradient():
    """Without a gradient (serving) ``ops.ssd_scan`` calls the forward
    alone and hands back two tensors, as before."""
    x, dtA, Bm, Cm = (t(a) for a in inputs(4, 1, 64, 2, 8, 8)[:4])
    x.requires_grad_()
    with torch.no_grad():
        out = ops.ssd_scan(x, dtA, Bm, Cm, chunk=32)
    assert len(out) == 2 and out[0].grad_fn is None


def test_ssd_scan_bwd_wrappers_refuse_cpu_tensors_and_bad_shapes():
    LAUNCH_COUNTS.clear()
    x, dtA, Bm, Cm, s0, dy, dfin = (t(a) for a in inputs(5, 1, 64, 2, 8, 4))
    _, _, states = tssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=32,
                                     return_states=True)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_bwd(x, dtA, Bm, Cm, states, dy, dfin, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dtA, Bm, Cm, chunk=32, initial_state=s0)
    for fn in (tssd.ssd_scan_bwd_ref, tssd.ssd_scan_bwd):
        with pytest.raises(ValueError, match="states"):
            fn(x, dtA, Bm, Cm, states[:, :, :1], dy, chunk=32)
        with pytest.raises(ValueError, match="dy"):
            fn(x, dtA, Bm, Cm, states, dy[:, :32], chunk=32)
        with pytest.raises(ValueError, match="dfinal"):
            fn(x, dtA, Bm, Cm, states, dy, dfin[..., :2], chunk=32)
    for fn in (tssd.ssd_scan_ref, tssd.ssd_scan):
        with pytest.raises(ValueError, match="initial_state"):
            fn(x, dtA, Bm, Cm, chunk=32, initial_state=s0[:, :1])
    assert sum(LAUNCH_COUNTS.values()) == 0


def test_bf16_plain_backward_returns_the_operands_dtypes():
    x, dtA, Bm, Cm, s0, dy, _ = (t(a) for a in inputs(6, 1, 64, 2, 8, 4))
    xb, Bb, Cb, dyb = (a.bfloat16() for a in (x, Bm, Cm, dy))
    y, fin, states = tssd.ssd_scan_ref(xb, dtA, Bb, Cb, chunk=32,
                                       initial_state=s0,
                                       return_states=True)
    assert y.dtype == fin.dtype == torch.bfloat16
    assert states.dtype == torch.float32
    grads = tssd.ssd_scan_bwd_ref(xb, dtA, Bb, Cb, states, dyb, chunk=32)
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.bfloat16,
                                        torch.float32]
    # through the Function, the start state's gradient in its own dtype
    sb = s0.bfloat16().requires_grad_()
    y, _ = ops.ssd_scan(xb, dtA, Bb, Cb, chunk=32, initial_state=sb)
    y.float().sum().backward()
    assert sb.grad.dtype == torch.bfloat16
