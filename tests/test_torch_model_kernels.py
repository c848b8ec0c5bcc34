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
import jax
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


def misses_kernel_tolerance(got, want):
    """How many elements of ``got`` lie beyond the tolerance the card
    holds the bf16 flash kernel to against the plain version
    (``assert_kernel_close`` in tests/test_torch_cuda.py, ``kernel_close``
    in chip_smoke.py): 1e-5 plus one bf16 step, 2**-7 of |want|."""
    got, want = as_f32(got), as_f32(want)
    return int((np.abs(got - want) > 1e-5 + 2.0 ** -7 * np.abs(want)).sum())


def emulate_tensor_core_flash(q, k, v, p_parts):
    """The bf16 CUDA kernel's arithmetic (``flash_tc_kernel``), causal,
    Sq == Sk, in plain torch: float32 scores of the bf16 q and k (the
    products exact, the sums in float32), scaled after the product; an
    online softmax over 64-key tiles; P V with P in bf16 parts, each
    product summed in float32. ``p_parts`` "hi_lo": p = hi + lo, hi =
    bf16(p), lo = bf16(p - hi), as the kernel does; "bf16": p rounded to
    bf16 once; "f32": p kept whole (the float32 SIMT kernel's P V). The
    row sum adds the float32 p."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, d)
    m = torch.full((B, KV, H // KV, S), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, S, d))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        kt, vt = k[:, k0:k0 + 64].float(), v[:, k0:k0 + 64].float()
        ok = qpos >= k0 + torch.arange(kt.shape[1])[None, :]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kt) * d ** -0.5
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        hi = p.bfloat16().float()
        parts = {"hi_lo": [hi, (p - hi).bfloat16().float()], "bf16": [hi],
                 "f32": [p]}[p_parts]
        acc = alpha[..., None] * acc
        for part in parts:
            acc = acc + torch.einsum("bkgqs,bskd->bkgqd", part, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, d).to(q.dtype)


@pytest.mark.parametrize("p_parts", ["hi_lo", "bf16", "f32"])
def test_tensor_core_flash_needs_p_in_two_bf16_parts(p_parts):
    """Why the bf16 kernel splits p: at B 1, S 1024, H 4 / KV 2, d 64,
    causal, P V with p = hi + lo (or p whole) lies within the card's bf16
    tolerance of the plain version and of the Pallas kernel (interpret
    mode) at every element; with p rounded once to bf16 (the usual
    flash-attention shortcut) over 1% of the elements lie beyond it."""
    shapes = ((1, 1024, 4, 64), (1, 1024, 2, 64), (1, 1024, 2, 64))
    q, k, v = inputs(1, "bfloat16", *shapes)
    got = emulate_tensor_core_flash(to_torch(q), to_torch(k), to_torch(v),
                                    p_parts)
    plain = attention_ref(to_torch(q), to_torch(k), to_torch(v))
    pallas = jax.jit(jax_flash)(*(jnp.asarray(a) for a in (q, k, v)))
    misses = [misses_kernel_tolerance(got, want) for want in (plain, pallas)]
    if p_parts != "bf16":
        assert misses == [0, 0]
    else:
        assert min(misses) > 0.01 * got.numel()


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


# The CUDA decode kernel's blocking (csrc/decode_attention.cu), emulated:
# the card's 132 SMs, as the binding reads them; a lane holds 8 elements
# of a row; four warps a block; a group of more than 8 heads in chunks.
DECODE_SMS, LANE_ELEMS, WARPS, HEAD_CHUNK = 132, 8, 4, 8


def decode_split_len(B, S, KV, G, sms=DECODE_SMS):
    """``decode_split_len`` of ``csrc/model_ops.h``: as many splits as
    fill one wave of four blocks an SM (one head a block, G 1) or three
    (a chunk of eight heads), each a multiple of 16 slots."""
    blocks = B * KV * -(-G // HEAD_CHUNK)
    splits = max((4 if G == 1 else 3) * sms // blocks, 1)
    length = -(-S // splits)
    return -(-length // 16) * 16


def _merge(m, l, acc):
    """Online-softmax states (max in log2 units, sum, unnormalised
    output) merged over the last dim of m and l; acc is m's shape + (d,).
    """
    mx = m.amax(-1, keepdim=True)
    w = torch.exp2(m - mx)
    return mx.squeeze(-1), (w * l).sum(-1), (w[..., None] * acc).sum(-2)


def emulate_split_decode(q, k, v, valid_len, sms=DECODE_SMS):
    """The CUDA decode kernel's arithmetic in plain torch. Float32 scores
    of the upcast q and k, times c = scale log2(e); the cache cut into
    splits of ``decode_split_len`` slots; in a split, warp w's step t
    covers slots s0 + (t * 4 + w) * rpw + [0, rpw), rpw = 32 / lpr rows
    of lpr lanes, and each (warp, row) keeps its own running max, sum and
    output, updated once a stage of 4 (bf16) or 2 (float32) steps:
    p = ok ? 2^(s - m_new) : 0, alpha = 2^(m_prev - m_new). At the end of
    a split the rows of a warp merge pairwise (rows 1, 2, 4, ... apart, as
    the shuffles pair them), then the warps; the splits merge last, with
    the 1e-30 floor on the normaliser. Returns (out in q's dtype, the
    split length)."""
    B, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    lpr = 1
    while lpr * LANE_ELEMS < d:
        lpr *= 2
    rpw = 32 // lpr
    steps = 8 // q.element_size()
    c = np.float32(np.float32(d ** -0.5) * np.float32(1.4426950408889634))
    vl = min(int(valid_len), S)
    qg = q.float().reshape(B, KV, G, d)
    s_all = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * float(c)
    v_all = v.float().permute(0, 2, 1, 3)                  # (B, KV, S, d)
    split = decode_split_len(B, S, KV, G, sms)
    parts = []
    for s0 in range(0, S, split):
        s1 = min(s0 + split, vl)
        per_stage = steps * WARPS * rpw
        n_stage = max(-(-(s1 - s0) // per_stage), 0)
        m = torch.full((B, KV, G, WARPS, rpw), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (d,))
        t, w, r = torch.meshgrid(torch.arange(steps), torch.arange(WARPS),
                                 torch.arange(rpw), indexing="ij")
        for j in range(n_stage):
            slot = s0 + ((j * steps + t) * WARPS + w) * rpw + r  # (U, W, R)
            ok = slot < s1
            safe = torch.where(ok, slot, 0)
            s = torch.where(ok, s_all[..., safe], -1e30)   # (B,KV,G,U,W,R)
            m_new = torch.maximum(m, s.amax(3))
            alpha = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(s - m_new[:, :, :, None]), 0.0)
            l = alpha * l + p.sum(3)
            vt = v_all[:, :, safe]                          # (B,KV,U,W,R,d)
            acc = alpha[..., None] * acc + torch.einsum(
                "bkguwr,bkuwrd->bkgwrd", p, vt)
            m = m_new
        off = 1
        while off < rpw:
            pair = torch.arange(rpw) ^ off
            m, l, acc = _merge(torch.stack([m, m[..., pair]], -1),
                               torch.stack([l, l[..., pair]], -1),
                               torch.stack([acc, acc[..., pair, :]], -2))
            off *= 2
        parts.append(_merge(m[..., 0], l[..., 0], acc[..., 0, :]))
    ms, ls, accs = zip(*parts)
    m, l, acc = _merge(torch.stack(ms, -1), torch.stack(ls, -1),
                       torch.stack(accs, -2))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, d).to(q.dtype), split


@pytest.mark.parametrize("vl", [0, 1, 257, 1030])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_blocking_matches_pallas_and_plain(vl, dtype):
    """The split, warp and row states of the CUDA decode kernel, merged
    as it merges them, give what the Pallas kernel (interpret mode) and
    the plain version give, within the card's kernel tolerance: at qwen2's
    serving shape (B 2, 1088 slots, 14 / 2 heads of 64) the splits are 16
    slots (68 of them), so a warp's stage holds one step of slots and
    three masked ones, valid_len 257 ends in the first warp tile of split
    16, and 0 leaves every split empty: zeros, no NaN."""
    B, S, H, KV, d = 2, 1088, 14, 2, 64
    q, k, v = inputs(S + vl, dtype, (B, H, d), (B, S, KV, d),
                     (B, S, KV, d))
    got, split = emulate_split_decode(to_torch(q), to_torch(k), to_torch(v),
                                      vl)
    assert split == 16
    assert bool(torch.isfinite(got).all())
    plain = decode_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                 torch.tensor(vl, dtype=torch.int32))
    pallas = jax.jit(jax_decode)(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.int32(vl))
    assert [misses_kernel_tolerance(got, want)
            for want in (plain, pallas)] == [0, 0]
    if vl == 0:
        assert not got.any()
