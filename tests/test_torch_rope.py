"""The rotary embedding (``kernels/rope.py``, ``kernels.ops.rope``).

On the CPU: the plain version is the formula the model layer ran before
the kernel, bit for bit; the ``autograd.Function``'s backward equals
autograd through the plain version, bit for bit; the wrappers' refusals;
the meta route's recorded work. On the card (marker ``gpu``; skips
without a CUDA device): the kernel forward and backward ``torch.equal``
to the plain version run on the card's tensors. This module imports no
JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rope.py
"""
import pytest
import torch

from repro_torch.kernels import LAUNCH_COUNTS, reset_launch_counts, work
from repro_torch.kernels import ops as kops
from repro_torch.kernels import meta
from repro_torch.kernels import rope as R
from repro_torch.launch.analysis import OpCensus

BF16, F32, I32, I64 = torch.bfloat16, torch.float32, torch.int32, torch.int64


def formula(x, positions, theta):
    """The model layer's rotary embedding before the kernel
    (``models/layers.py:apply_rope``), as it was written."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def operands(B, Sq, Sk, H, KV, d, dtype, device="cpu", q_at=0, k_at=0,
             pos_dtype=I64, seed=0):
    """q, k (None for Sk = 0) and their positions, ``q_at`` and ``k_at``
    onwards, drawn on the CPU and moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn((B, Sq, H, d), generator=g) * 4).to(dtype)
    pos_q = torch.arange(q_at, q_at + Sq, dtype=pos_dtype)
    k = pos_k = None
    if Sk:
        k = (torch.randn((B, Sk, KV, d), generator=g) * 4).to(dtype)
        pos_k = torch.arange(k_at, k_at + Sk, dtype=pos_dtype)
    move = (lambda t: None if t is None else t.to(device))
    return tuple(map(move, (q, k, pos_q, pos_k)))


# (B, Sq, Sk, H, KV, d, q_at, k_at, theta): training and prefill shapes,
# a longer k than q, decode steps (one token at its cache position), and
# q alone (Sk = 0: decode's cross attention)
CASES = [
    (2, 16, 16, 4, 2, 64, 0, 0, 1e4),
    (2, 12, 12, 6, 2, 80, 0, 0, 1e4),
    (1, 8, 8, 8, 1, 112, 0, 0, 5e4),
    (2, 8, 8, 4, 4, 128, 0, 0, 1e6),
    (1, 5, 5, 2, 1, 256, 0, 0, 1e4),
    (2, 7, 7, 4, 4, 32, 0, 0, 1e4),
    (2, 5, 9, 4, 2, 64, 4, 0, 1e4),
    (3, 1, 1, 4, 2, 64, 1500, 1500, 1e6),
    (2, 1, 1, 14, 2, 64, 32767, 32767, 1e6),
    (2, 1, 0, 4, 2, 64, 57, 0, 1e4),
]
IDS = [f"{c[1]}x{c[2]}-h{c[3]}/{c[4]}-d{c[5]}-at{c[6]}" for c in CASES]


def _rope_autograd(fn, q, k, pos_q, pos_k, theta, seed=1):
    """(q', k', dq, dk) of ``fn`` (a rope with the wrapper's signature)
    against fixed output gradients."""
    q = q.detach().clone().requires_grad_()
    k = None if k is None else k.detach().clone().requires_grad_()
    qo, ko = fn(q, k, pos_q, pos_k, theta)
    g = torch.Generator().manual_seed(seed)
    outs = [o for o in (qo, ko) if o is not None]
    seeds = [torch.randn(o.shape, generator=g).to(o.dtype).to(o.device)
             for o in outs]
    ins = [x for x in (q, k) if x is not None]
    grads = torch.autograd.grad(outs, ins, seeds)
    return qo, ko, grads[0], (grads[1] if k is not None else None)


def _plain_pair(q, k, pos_q, pos_k, theta):
    return (formula(q, pos_q, theta),
            None if k is None else formula(k, pos_k, theta))


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rope_ref_is_the_formula_it_replaces(case, dtype):
    B, Sq, Sk, H, KV, d, q_at, k_at, theta = case
    q, k, pos_q, pos_k = operands(B, Sq, Sk, H, KV, d, dtype, q_at=q_at,
                                  k_at=k_at)
    got = R.rope_ref(q, k, pos_q, pos_k, theta)
    for a, b in zip(got, _plain_pair(q, k, pos_q, pos_k, theta)):
        _equal(a, b)
    # through the public op, no gradient needed
    for a, b in zip(kops.rope(q, k, pos_q, pos_k, theta), got):
        _equal(a, b)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_on_the_cpu_equals_autograd_through_the_plain_version(
        case, dtype):
    B, Sq, Sk, H, KV, d, q_at, k_at, theta = case
    args = operands(B, Sq, Sk, H, KV, d, dtype, q_at=q_at, k_at=k_at)
    got = _rope_autograd(kops.rope, *args, theta)
    want = _rope_autograd(_plain_pair, *args, theta)
    assert got[0].grad_fn.name().startswith("RopeBackward")
    for a, b in zip(got, want):
        _equal(a, b)
    # the plain backward alone: the inverse rotation of the gradients
    g = torch.Generator().manual_seed(1)
    dq = torch.randn(got[0].shape, generator=g).to(dtype)
    dk = None if Sk == 0 else torch.randn(got[1].shape, generator=g).to(
        dtype)
    gq, gk = R.rope_bwd_ref(dq, dk, args[2], args[3], theta)
    _equal(gq, got[2])
    _equal(gk, got[3])


def test_the_function_saves_only_the_positions():
    q, k, pos_q, pos_k = operands(2, 8, 8, 4, 2, 64, BF16)
    q.requires_grad_()
    k.requires_grad_()
    qo, _ = kops.rope(q, k, pos_q, pos_k, 1e4)
    saved = qo.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is pos_q and saved[1] is pos_k


def test_positions_may_be_int32_tensors_of_one_token():
    """Decode's form: the cache position, an int32 tensor reshaped to
    (1,), the same for q and k."""
    q, k, _, _ = operands(3, 1, 1, 4, 2, 64, BF16)
    pos = torch.tensor(1234, dtype=I32).reshape(1)
    qo, ko = kops.rope(q, k, pos, pos, 1e4)
    _equal(qo, formula(q, pos, 1e4))
    _equal(ko, formula(k, pos, 1e4))


def _refusals():
    """(label, operands, exception): what every route refuses."""
    q, k, pq, pk = operands(2, 4, 4, 4, 2, 64, BF16)
    q24 = operands(1, 4, 0, 2, 1, 24, BF16)[0]
    q272 = operands(1, 4, 0, 1, 1, 272, BF16)[0]
    return [
        ("q not 4-d", (q[0], None, pq, None), ValueError),
        ("head_dim 24", (q24, None, pq, None), ValueError),
        ("head_dim 272", (q272, None, pq, None), ValueError),
        ("k of another batch", (q, k[:1], pq, pk), ValueError),
        ("k of another head_dim", (q, k[..., :32], pq, pk), ValueError),
        ("k without pos_k", (q, k, pq, None), ValueError),
        ("pos_k without k", (q, None, pq, pk), ValueError),
        ("pos_q of another length", (q, k, pq[:3], pk), ValueError),
        ("pos_k of another length", (q, k, pq, pk[:3]), ValueError),
        ("float positions", (q, k, pq.float(), pk.float()), TypeError),
        ("positions of two dtypes", (q, k, pq, pk.int()), TypeError),
        ("k of another dtype", (q, k.float(), pq, pk), TypeError),
    ]


REFUSALS = _refusals()


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_every_route_refuses_what_the_kernel_does_not_take(case, device):
    _, args, exc = case
    args = tuple(None if t is None else t.to(device) for t in args)
    with pytest.raises(exc):
        kops.rope(*args, 1e4)
    with pytest.raises(exc):
        (R.rope_bwd_ref if device == "cpu" else meta.rope_bwd)(*args, 1e4)


def test_the_kernel_wrappers_refuse_a_cpu_tensor():
    q, k, pq, pk = operands(2, 4, 4, 4, 2, 64, BF16)
    before = dict(LAUNCH_COUNTS)
    for fn in (R.rope, R.rope_bwd):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            fn(q, k, pq, pk, 1e4)
    assert dict(LAUNCH_COUNTS) == before


@pytest.mark.parametrize("Sk", [6, 0], ids=["q and k", "q alone"])
def test_the_meta_route_records_the_work(Sk):
    B, S, H, KV, d = 2, 6, 4, 2, 64
    q, k, pq, pk = operands(B, S, Sk, H, KV, d, BF16, device="meta")
    q.requires_grad_()
    if k is not None:
        k.requires_grad_()
    with OpCensus() as census:
        qo, ko = kops.rope(q, k, pq, pk, 1e4)
        outs = [o for o in (qo, ko) if o is not None]
        torch.autograd.grad(outs, [x for x in (q, k) if x is not None],
                            [torch.empty_like(o) for o in outs])
    assert qo.shape == q.shape and qo.device.type == "meta"
    assert (ko is None) == (k is None)
    assert census.kernel_calls == {"rope": 1, "rope_bwd": 1}
    want = work.rope(B, S, Sk, H, 0 if k is None else KV, d, BF16)
    for name in ("rope", "rope_bwd"):
        assert census.kernels[name]["bytes"] == want.bytes
        assert census.kernels[name]["flops"] == want.flops
        assert census.kernels[name]["launches"] == 1
    # q and k read and written in bf16, the int64 positions read
    assert want.bytes == 2 * 2 * (B * S * H * d + B * Sk * KV * d) \
        + 8 * (S + Sk)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reset_launch_counts()
    return torch.device("cuda")


def _card_vs_plain(dev, case, dtype, pos_dtype=I64):
    """The kernel's (q', k', dq, dk) and the plain version's on the card's
    tensors, with the launches the kernel path counted."""
    B, Sq, Sk, H, KV, d, q_at, k_at, theta = case
    args = operands(B, Sq, Sk, H, KV, d, dtype, device=dev, q_at=q_at,
                    k_at=k_at, pos_dtype=pos_dtype)
    reset_launch_counts()
    got = _rope_autograd(kops.rope, *args, theta)
    launches = dict(LAUNCH_COUNTS)
    want = _rope_autograd(_plain_pair, *args, theta)
    torch.cuda.synchronize()
    return got, want, launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rope_kernel_equals_the_plain_version_on_the_card(dev, case, dtype):
    got, want, launches = _card_vs_plain(dev, case, dtype)
    for a, b in zip(got, want):
        _equal(a, b)
    assert launches == {"rope": 1, "rope_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_rope_kernel_at_smollm_training_shape(dev, dtype):
    """(32, 1024, 15 | 5, 64), the benchmark's b32x1024 layer."""
    got, want, launches = _card_vs_plain(
        dev, (32, 1024, 1024, 15, 5, 64, 0, 0, 1e4), dtype)
    for a, b in zip(got, want):
        _equal(a, b)
    assert launches == {"rope": 1, "rope_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 112, 128, 256])
def test_rope_kernel_decode_step_on_the_card(dev, d):
    """One token at a device-side int32 cache position, q and k, then q
    alone, without a gradient (serving)."""
    q, k, _, _ = operands(8, 1, 1, 8, 2, d, BF16, device=dev)
    for at in (0, 1281, 32767):
        pos = torch.tensor(at, dtype=I32, device=dev).reshape(1)
        reset_launch_counts()
        with torch.no_grad():
            qo, ko = kops.rope(q, k, pos, pos, 1e6)
            qa, none = kops.rope(q, None, pos, None, 1e6)
        assert dict(LAUNCH_COUNTS) == {"rope": 2} and none is None
        _equal(qo, formula(q, pos, 1e6))
        _equal(ko, formula(k, pos, 1e6))
        _equal(qa, qo)


@pytest.mark.gpu
def test_rope_kernel_refusals_on_the_card(dev):
    q, k, pq, pk = operands(2, 4, 4, 4, 2, 64, BF16, device=dev)
    with pytest.raises(TypeError):                 # float16
        R.rope(q.half(), None, pq, None, 1e4)
    with pytest.raises(ValueError, match="contiguous"):
        R.rope(q.transpose(1, 2), None, pq, None, 1e4)
    flat = torch.zeros(q.numel() + 4, dtype=BF16, device=dev)
    shifted = flat[4:].view(q.shape)               # rows 8 bytes off 16
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        R.rope(shifted, None, pq, None, 1e4)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        R.rope(q, k, pq, pk.cpu(), 1e4)
