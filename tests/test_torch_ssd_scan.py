"""The SSD scan's plain version against the JAX package: ``ssd_scan_ref``
(what the port runs on a CPU tensor, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card) against the JAX Pallas ``ssd_scan`` in
interpret mode and against the O(S^2) oracle ``repro/kernels/ref.py:
ssd_ref``, on the same numpy inputs made from a seed; and the wrapper's
rules (the chunk, mismatched shapes, CPU operands refused; the kernel's
own limits are held on the card, ``tests/test_torch_cuda.py``).

Shapes: ``tests/test_kernels.py``'s four sweep shapes, and one ragged
single chunk (S = L = 100, not a multiple of the kernel's 64-row tiles).

The CUDA kernels cannot run here, so ``emulate_ssd_kernels`` repeats their
arithmetic in plain torch: the three passes (chunk states, the state
recurrence, y) over the kernels' 64-row tiles, with the float32 operands
of three products as bf16 hi + lo where the bf16 kernels take them to the
tensor cores. It is held against the Pallas kernel and the plain version
under the card's own tolerance (``chip_smoke.scan_close``), over several
chunks, one ragged chunk, N 64 and 128, both dtypes.

Tolerances: float32, 2e-4 absolute, as ``test_kernels.py`` holds the
Pallas kernel to the oracle (the products are summed in other orders and
the decays exponentiated from cumulative sums taken in other orders).
bfloat16 inputs: both sides compute in float32 from the same rounded
inputs and round y and the state once, so one bf16 rounding step (2**-7
relative) plus the same float32 allowance.
"""
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as tssd

torch.set_num_threads(2)

ATOL = 2e-4
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

# (B, S, H, P, N, chunk)
SHAPES = [
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (2, 96, 3, 8, 32, 32),
    (1, 256, 2, 64, 64, 64),     # mamba2-like dims
    (1, 100, 2, 64, 32, 256),    # one ragged chunk: L = min(256, 100)
]


def scan_inputs(seed, B, S, H, P, N, dtype="float32"):
    """x, B_, C_ ~ 0.5 N(0, 1) in ``dtype``; dtA = -0.3 softplus(N(0, 1))
    in float32 (the decays of test_kernels.py's sweep)."""
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype]
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dtA = (-np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
           * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    return x.astype(np_dt), dtA, Bm.astype(np_dt), Cm.astype(np_dt)


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
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_scan(chunk):
    return jax.jit(functools.partial(jax_ssd_scan, chunk=chunk))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(B, S, H, P, N, chunk,
                                                  dtype):
    x, dtA, Bm, Cm = scan_inputs(S * H, B, S, H, P, N, dtype)
    y, fin = tssd.ssd_scan_ref(*map(to_torch, (x, dtA, Bm, Cm)),
                               chunk=chunk)
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert y.dtype == fin.dtype == want_dt
    assert y.shape == (B, S, H, P) and fin.shape == (B, H, P, N)
    assert y.is_contiguous() and fin.is_contiguous()
    jy, jfin = _jax_scan(chunk)(x, dtA, Bm, Cm)      # interpret mode
    assert_close(y, jy, dtype)
    assert_close(fin, jfin, dtype)
    oy, ofin = jref.ssd_ref(x, dtA, Bm, Cm)
    assert_close(y, oy, dtype)
    assert_close(fin, ofin, dtype)
    # kernels.ops sends a CPU tensor to the plain version
    oy2, ofin2 = kops.ssd_scan(*map(to_torch, (x, dtA, Bm, Cm)), chunk=chunk)
    assert torch.equal(oy2, y) and torch.equal(ofin2, fin)


def test_ssd_scan_plain_chunks_do_not_change_the_result():
    """One chunk of 96 and three of 32 compute the same scan."""
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(3, 2, 96, 3, 16, 8))
    y1, f1 = tssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=96)
    y3, f3 = tssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=32)
    torch.testing.assert_close(y1, y3, rtol=0, atol=ATOL)
    torch.testing.assert_close(f1, f3, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S,chunk", [(300, 256), (100, 64), (96, 0)])
def test_ssd_scan_refuses_a_chunk_that_does_not_divide_s(S, chunk):
    """The reference asserts S % min(chunk, S) == 0 on both of its paths;
    the port raises a ValueError naming the rule, on the CPU and before
    any launch on the card."""
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(4, 1, S, 1, 8, 8))
    for fn in (tssd.ssd_scan_ref, tssd.ssd_scan):
        with pytest.raises(ValueError, match="must divide"):
            fn(x, dtA, Bm, Cm, chunk=chunk)


def test_ssd_scan_wrapper_refuses_cpu_tensors_and_mismatched_shapes():
    LAUNCH_COUNTS.clear()
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(5, 1, 64, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dtA, Bm, Cm, chunk=64)
    for fn in (tssd.ssd_scan_ref, tssd.ssd_scan):
        with pytest.raises(ValueError, match="dtA must be"):
            fn(x, dtA[:, :-1], Bm, Cm, chunk=64)
        with pytest.raises(ValueError, match="must be"):
            fn(x, dtA, Bm, Cm[..., :-1], chunk=64)
    assert sum(LAUNCH_COUNTS.values()) == 0


# ---------------------------------------------------------------------------
# the CUDA kernels' blocking and products, emulated
# ---------------------------------------------------------------------------

TILE = 64  # rows of a query, key or chunk-state tile in csrc/ssd_scan.cu


def split_parts(a, parts):
    """``a`` (float32) as the kernel feeds it to a product: "hi_lo" two
    bf16 parts, hi = bf16(a), lo = bf16(a - hi) (the bf16 kernels, on the
    tensor cores); "bf16" one bf16 rounding; "f32" whole (the float32
    SIMT kernels)."""
    if parts == "f32":
        return [a]
    hi = a.bfloat16().float()
    return [hi, (a - hi).bfloat16().float()] if parts == "hi_lo" else [hi]


def emulate_ssd_kernels(x, dtA, B_, C_, chunk, parts):
    """The arithmetic of ``csrc/ssd_scan.cu`` in plain torch, float32 from
    x's values. Pass 1, per chunk: A_cum, and the chunk's own state
    x^T (B * decay) over 64-row key tiles, with B * decay as ``parts``.
    Pass 2: S_{c+1} = exp(A_cum_c[-1]) S_c + dS_c from zero. Pass 3, per
    64-row query tile of a chunk: exp(A_cum[t]) C S_c^T with S_c as
    ``parts``, then over the causal key tiles the scores C B^T (bf16
    products, exact in float32), masked and decayed, as ``parts``, times
    x. Returns y and the final state in x's dtype."""
    Bb, S, H, P = x.shape
    L = min(chunk, S)
    xs, Bs, Cs = (t.float().transpose(1, 2) for t in (x, B_, C_))
    As = dtA.float().transpose(1, 2)
    nc = S // L
    a_cum, d_states = [], []
    for c in range(nc):                                   # pass 1
        sl = slice(c * L, (c + 1) * L)
        A = torch.cumsum(As[:, :, sl], -1)
        decay = torch.exp(A[..., -1:] - A)
        dS = 0.0
        for s0 in range(0, L, TILE):
            ks = slice(c * L + s0, c * L + min(s0 + TILE, L))
            bd = Bs[:, :, ks] * decay[..., s0:s0 + TILE, None]
            xt = xs[:, :, ks].transpose(-1, -2)
            for part in split_parts(bd, parts):
                dS = dS + xt @ part
        a_cum.append(A)
        d_states.append(dS)
    state = torch.zeros((Bb, H, P, Bs.shape[-1]))
    starts = []
    for c in range(nc):                                   # pass 2
        starts.append(state)
        state = torch.exp(a_cum[c][..., -1])[..., None, None] * state \
            + d_states[c]
    y = torch.zeros_like(xs)
    for c in range(nc):                                   # pass 3
        A = a_cum[c]
        s_parts = split_parts(starts[c], parts)
        for t0 in range(0, L, TILE):
            qs = slice(c * L + t0, c * L + min(t0 + TILE, L))
            tq = torch.arange(t0, min(t0 + TILE, L))
            Cq = Cs[:, :, qs]
            acc = 0.0
            for part in s_parts:
                acc = acc + Cq @ part.transpose(-1, -2)
            acc = acc * torch.exp(A[..., tq])[..., None]
            for s0 in range(0, t0 + 1, TILE):
                ks = slice(c * L + s0, c * L + min(s0 + TILE, L))
                sk = torch.arange(s0, min(s0 + TILE, L))
                G = Cq @ Bs[:, :, ks].transpose(-1, -2)
                seg = A[..., tq, None] - A[..., None, sk]
                Pm = torch.where(tq[:, None] >= sk[None, :],
                                 G * torch.exp(seg), 0.0)
                for part in split_parts(Pm, parts):
                    acc = acc + part @ xs[:, :, ks]
            y[:, :, qs] = acc
    return (y.transpose(1, 2).contiguous().to(x.dtype),
            state.to(x.dtype))


def misses_scan_tolerance(got, want, dtype):
    """How many elements of ``got`` lie beyond the tolerance the card holds
    the scan kernels to against the plain version (``scan_close`` in
    chip_smoke.py, ``assert_scan_close`` in tests/test_torch_cuda.py):
    1e-5 of the largest |want|, plus one bf16 step (2**-7 of |want|) for
    bfloat16."""
    got, want = as_f32(got), as_f32(want)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    bound = 1e-5 * np.abs(want).max() + rtol * np.abs(want)
    return int((np.abs(got - want) > bound).sum())


# (B, S, H, P, N, chunk): 4 chunks of 2 tiles (N 64); mamba2's P, N and
# chunk over 4 chunks (N 128); one ragged chunk (L = S = 100); 4 chunks of
# one tile
EMULATED_SHAPES = [
    (1, 512, 2, 32, 64, 128),
    (1, 1024, 2, 64, 128, 256),
    (2, 100, 2, 64, 128, 256),
    (1, 256, 3, 16, 64, 64),
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", EMULATED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_kernel_blocking_matches_pallas_and_plain(B, S, H, P, N,
                                                       chunk, dtype):
    """The three passes of the CUDA scan, tiled as the kernels tile them
    and with their products' operands (bf16: the float32 operands as hi +
    lo; float32: whole), give what the Pallas kernel (interpret mode) and
    the plain version give, within the card's scan tolerance, for y and
    the final state."""
    x, dtA, Bm, Cm = scan_inputs(S * H + N, B, S, H, P, N, dtype)
    parts = "hi_lo" if dtype == "bfloat16" else "f32"
    got = emulate_ssd_kernels(*map(to_torch, (x, dtA, Bm, Cm)), chunk,
                              parts)
    plain = tssd.ssd_scan_ref(*map(to_torch, (x, dtA, Bm, Cm)), chunk=chunk)
    pallas = _jax_scan(chunk)(x, dtA, Bm, Cm)
    for g, p, j in zip(got, plain, pallas):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert bool(torch.isfinite(g).all())
        assert [misses_scan_tolerance(g, want, dtype)
                for want in (p, j)] == [0, 0]


@pytest.mark.parametrize("parts", ["hi_lo", "bf16"])
def test_tensor_core_scan_needs_two_bf16_parts(parts):
    """Why the bf16 kernels split their float32 operands (the masked
    scores, the state, B * decay): at mamba2's P, N and chunk over four
    chunks, hi + lo lies within the card's scan tolerance of the plain
    version and of the Pallas kernel at every output; each operand rounded
    once to bf16 puts over 1% of y beyond it."""
    B, S, H, P, N, chunk = 1, 1024, 2, 64, 128, 256
    x, dtA, Bm, Cm = scan_inputs(S * H + N, B, S, H, P, N, "bfloat16")
    y, _ = emulate_ssd_kernels(*map(to_torch, (x, dtA, Bm, Cm)), chunk,
                               parts)
    plain, _ = tssd.ssd_scan_ref(*map(to_torch, (x, dtA, Bm, Cm)),
                                 chunk=chunk)
    pallas, _ = _jax_scan(chunk)(x, dtA, Bm, Cm)
    misses = [misses_scan_tolerance(y, want, "bfloat16")
              for want in (plain, pallas)]
    if parts == "hi_lo":
        assert misses == [0, 0]
    else:
        assert min(misses) > 0.01 * y.numel()
