"""The kernels' shape-and-work routes (``kernels.meta``) and their work
(``kernels.work``).

- Every one of the 16 kernels (rows 1-15 of PERF.md §6 and rope's
  backward), called through
  its public wrapper (``kernels.ops``) or its ``autograd.Function``'s
  backward with meta operands, gives its plain version's output shapes
  and dtypes on the same small CPU inputs, computes nothing, launches
  nothing (``LAUNCH_COUNTS`` stays as it was) and reports exactly one
  call to the census.
- The work functions reproduce PERF.md §6's "Bound ms" column and its
  "(by)" at the table's shapes, within 1% (the table rounds to 3-4
  figures).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import LAUNCH_COUNTS, route, work
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import rope
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.analysis import OpCensus, bound_ms

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32


def _inputs(spec, device, seed=0):
    """(shape, dtype[, low, high]) -> a tensor: random values on the CPU,
    an empty tensor on meta."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape, dtype, *rng in spec:
        if device == "meta":
            out.append(torch.empty(shape, dtype=dtype, device="meta"))
        elif dtype == I32:
            lo, hi = rng or (0, 8)
            out.append(torch.randint(lo, hi, shape, generator=g,
                                     dtype=I32))
        else:
            out.append(torch.rand(shape, generator=g).to(dtype) + 0.1)
    return out


def _shapes(tree):
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


# (kernel, input spec, call): the forward kernels through kernels.ops
FORWARD = {
    "ring_write": ([((64, 3), F32), ((5, 3), F32), ((), I32)],
                   lambda d, b, p: ops.ring_write(d, b, p)),
    "ring_write fields": ([((64, 3), F32), ((64, 1), F32), ((5, 3), F32),
                           ((5, 1), F32), ((), I32)],
                          lambda d1, d2, b1, b2, p: ops.ring_write_fields(
                              [d1, d2], [b1, b2], p)),
    "ring_gather": ([((64, 3), F32), ((8,), I32, 0, 64)],
                    lambda d, i: ops.ring_gather(d, i)),
    "ring_gather fields": ([((64, 3), F32), ((64, 1), F32),
                            ((8,), I32, 0, 64)],
                           lambda d1, d2, i: ops.ring_gather_fields(
                               [d1, d2], i)),
    "per_scores": ([((64,), F32), ((64,), F32)],
                   lambda p, g: ops.per_scores(p, g, 0.6)),
    "per_topk": ([((64,), F32), ((64,), F32)],
                 lambda p, g: ops.per_topk(p, g, 0.6, 8)),
    "priority_scatter": ([((64,), F32), ((8,), I32, 0, 64), ((8,), F32)],
                         lambda p, i, v: ops.priority_scatter(p, i, v)),
    "ring_write_rowloop": ([((64, 3), F32), ((5, 3), F32), ((), I32)],
                           lambda d, b, p: ops.ring_write_rowloop(d, b, p)),
    "ring_gather_rowloop": ([((64, 3), F32), ((8,), I32, 0, 64)],
                            lambda d, i: ops.ring_gather_rowloop(d, i)),
    "rmsnorm": ([((4, 5, 16), BF16), ((16,), F32)],
                lambda x, w: ops.rmsnorm(x, w)),
    "rope": ([((2, 6, 4, 32), BF16), ((2, 6, 2, 32), BF16),
              ((6,), I32, 0, 64), ((6,), I32, 0, 64)],
             lambda q, k, pq, pk: ops.rope(q, k, pq, pk, 1e4)),
    "flash_attention": ([((2, 8, 4, 16), BF16), ((2, 12, 2, 16), BF16),
                         ((2, 12, 2, 16), BF16)],
                        lambda q, k, v: ops.flash_attention(
                            q, k, v, window=6, prefix_len=3)),
    "decode_attention": ([((2, 4, 16), BF16), ((2, 9, 2, 16), BF16),
                          ((2, 9, 2, 16), BF16), ((), I32, 1, 9)],
                         ops.decode_attention),
    "ssd_scan": ([((2, 8, 2, 4), F32), ((2, 8, 2), F32), ((2, 8, 2, 3), F32),
                  ((2, 8, 2, 3), F32)],
                 lambda x, a, b, c: ops.ssd_scan(x, a, b, c, chunk=4)),
}
NAME = {"ring_write fields": "ring_write", "ring_gather fields":
        "ring_gather"}


@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_meta_route_matches_the_plain_version(case):
    spec, call = FORWARD[case]
    want = _shapes(call(*_inputs(spec, "cpu")))
    before = dict(LAUNCH_COUNTS)
    with OpCensus() as census:
        got = call(*_inputs(spec, "meta"))
    assert _shapes(got) == want
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, (list, tuple)) else [got]))
    assert census.kernel_calls == {NAME.get(case, case): 1}
    assert dict(LAUNCH_COUNTS) == before


def _backward(fn, spec, device, seed=0):
    """-> (the forward's outputs, the gradients of their sum of every
    float output) through ``fn`` (an autograd.Function's apply)."""
    xs = [t.requires_grad_() if t.is_floating_point() else t
          for t in _inputs(spec, device, seed)]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    seeds = [torch.ones_like(o) if device == "cpu" else torch.empty_like(o)
             for o in outs]
    grads = torch.autograd.grad(outs, [x for x in xs if x.requires_grad],
                                seeds)
    return outs, grads


BACKWARD = {
    "rmsnorm_bwd": ([((6, 16), BF16), ((16,), F32)],
                    lambda x, w: rms.RMSNorm.apply(x, w, 1e-6)),
    "rope_bwd": ([((2, 6, 4, 32), BF16), ((2, 6, 2, 32), BF16),
                  ((6,), I32, 0, 64), ((6,), I32, 0, 64)],
                 lambda q, k, pq, pk: rope.Rope.apply(q, k, pq, pk, 1e4)),
    "flash_attention_bwd": ([((2, 8, 4, 16), BF16), ((2, 8, 2, 16), BF16),
                             ((2, 8, 2, 16), BF16)],
                            lambda q, k, v: fa.FlashAttention.apply(
                                q, k, v, True, None, None)),
    "ssd_scan_bwd": ([((2, 8, 2, 4), F32), ((2, 8, 2), F32),
                      ((2, 8, 2, 3), F32), ((2, 8, 2, 3), F32),
                      ((2, 2, 4, 3), F32)],
                     lambda x, a, b, c, s: ssd.SSDScan.apply(x, a, b, c, s,
                                                             4)),
}
FORWARD_OF = {"rmsnorm_bwd": "rmsnorm", "flash_attention_bwd":
              "flash_attention", "ssd_scan_bwd": "ssd_scan",
              "rope_bwd": "rope"}


@pytest.mark.parametrize("kernel", list(BACKWARD))
def test_backward_meta_route_matches_the_plain_version(kernel):
    """The autograd.Function on meta operands takes the meta routes in
    its forward and its backward."""
    spec, fn = BACKWARD[kernel]
    want = _shapes(_backward(fn, spec, "cpu"))
    with OpCensus() as census:
        got = _backward(fn, spec, "meta")
    assert _shapes(got) == want
    assert census.kernel_calls == {FORWARD_OF[kernel]: 1, kernel: 1}


def test_backward_routes_called_directly():
    x, w, dy = _inputs([((6, 16), BF16), ((16,), F32), ((6, 16), BF16)],
                       "cpu")
    mx, mw, mdy = _inputs([((6, 16), BF16), ((16,), F32), ((6, 16), BF16)],
                          "meta")
    assert _shapes(meta.rmsnorm_bwd(mx, mw, mdy)) == _shapes(
        rms.rmsnorm_bwd_ref(x, w, dy))
    args = _inputs([((2, 16, 2, 4), F32), ((2, 16, 2), F32),
                    ((2, 16, 2, 3), F32), ((2, 16, 2, 3), F32)], "cpu")
    y, _, states = ssd.ssd_scan_ref(*args, chunk=8, return_states=True)
    margs = [torch.empty_like(a, device="meta") for a in args]
    mstates = meta.ssd_scan(*margs, chunk=8, return_states=True)[2]
    assert _shapes(mstates) == _shapes(states)
    want = ssd.ssd_scan_bwd_ref(*args, states, y, chunk=8)
    got = meta.ssd_scan_bwd(*margs, mstates, torch.empty_like(margs[0]),
                            chunk=8)
    assert _shapes(got) == _shapes(want)


def test_decode_attention_refuses_a_gradient_on_meta():
    q, k, v = (torch.empty(s, device="meta", requires_grad=True) for s in
               ((2, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    with pytest.raises(ValueError, match="no backward kernel"):
        ops.decode_attention(q, k, v, torch.empty((), dtype=I32,
                                                  device="meta"))


def test_empty_calls_launch_nothing_on_meta():
    """An empty write or gather, or k = 0, counts no call, as the
    wrappers count no launch."""
    d = torch.empty((64, 3), device="meta")
    with OpCensus() as census:
        ops.ring_write(d, torch.empty((0, 3), device="meta"),
                       torch.empty((), dtype=I32, device="meta"))
        ops.ring_gather(d, torch.empty((0,), dtype=I32, device="meta"))
        ops.per_topk(torch.empty(64, device="meta"),
                     torch.empty(64, device="meta"), 0.6, 0)
    assert census.kernel_calls == {}


def test_route_is_the_operand_device():
    assert route(torch.empty(1)) == "cpu"
    assert route(torch.empty(1, device="meta")) == "meta"

    class Elsewhere:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="no kernel route"):
        route(Elsewhere())


def test_meta_routes_refuse_what_the_plain_versions_refuse():
    with pytest.raises(ValueError):
        ops.ssd_scan(*(torch.empty(s, device="meta") for s in
                       ((1, 10, 2, 4), (1, 10, 2), (1, 10, 2, 3),
                        (1, 10, 2, 3))), chunk=4)
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.empty((4, 16), device="meta"),
                    torch.empty((8,), device="meta"))
    with pytest.raises(ValueError):
        ops.per_topk(torch.empty(8, device="meta"),
                     torch.empty(8, device="meta"), 0.6, 9)


# PERF.md §6, "Bound ms (by)": (row, work, bound ms, by)
CAP, ROWS, B = 262_144, 512, 8192
PAIRS_UNIQUE = round(CAP * (1 - (1 - 1 / CAP) ** B))   # distinct draws
PERF_ROWS = [
    (1, work.ring_write(ROWS, 10 * 4), 0.0000122, "bytes"),
    (2, work.ring_gather(B, 10 * 4, PAIRS_UNIQUE), 0.000204, "bytes"),
    (3, work.per_scores(CAP), 0.000939, "bytes"),
    (4, work.per_topk(CAP, B), 0.000646, "bytes"),
    (5, work.priority_scatter(B, B), 0.0000293, "bytes"),
    (6, work.ring_write_rowloop(ROWS, 10 * 4), 0.0000122, "bytes"),
    (7, work.ring_gather_rowloop(B, 10 * 4, PAIRS_UNIQUE), 0.000204,
     "bytes"),
    (8, work.rmsnorm(8 * 1024, 896, BF16), 0.00877, "bytes"),
    (9, work.flash_attention(8, 1024, 1024, 14, 2, 64, BF16), 0.01521,
     "operations"),
    (10, work.decode_attention(8, 32768, 14, 2, 64, BF16), 0.04007,
     "bytes"),
    (11, work.ssd_scan(8, 1024, 24, 64, 128, 256, BF16), 0.04625, "bytes"),
    (12, work.rmsnorm_bwd(8 * 1024, 896, BF16), 0.01315, "bytes"),
    (13, work.flash_attention_bwd(8, 1024, 1024, 14, 2, 64, BF16), 0.03804,
     "operations"),
    (14, work.ssd_scan_bwd(8, 1024, 24, 64, 128, 256, BF16), 0.09062,
     "bytes"),
    (15, work.rope(32, 1024, 1024, 15, 5, 64, BF16), 0.05009, "bytes"),
]


@pytest.mark.parametrize("row", PERF_ROWS, ids=[f"row{r[0]}"
                                                for r in PERF_ROWS])
def test_work_reproduces_the_perf_table_bounds(row):
    _, w, want_ms, want_by = row
    ms, by = bound_ms(w)
    assert by == want_by
    assert math.isclose(ms, want_ms, rel_tol=0.01)


def test_the_work_functions_cover_the_fourteen_kernels():
    """The fourteen ported and backward kernels, and rope's pair."""
    assert len(work.KERNELS) == 16 and len(set(work.KERNELS)) == 16
    for name in work.KERNELS:
        assert callable(getattr(work, name)) and callable(getattr(meta,
                                                                  name))
    # device launches a call: PERF.md §6 and the kernels' sources
    assert {n: getattr(work, n)(*args).launches for n, args in (
        ("per_topk", (CAP, B)), ("rmsnorm_bwd", (8, 16, BF16)),
        ("flash_attention_bwd", (1, 8, 8, 2, 1, 16, BF16)),
        ("decode_attention", (1, 8, 2, 1, 16, BF16)),
        ("ssd_scan", (1, 8, 1, 4, 4, 4, BF16)),
        ("ssd_scan_bwd", (1, 8, 1, 4, 4, 4, BF16)),
        ("rope", (1, 8, 8, 2, 1, 16, BF16)),
        ("rope_bwd", (1, 8, 8, 2, 1, 16, BF16)))} == {
        "per_topk": 3, "rmsnorm_bwd": 2, "flash_attention_bwd": 3,
        "decode_attention": 2, "ssd_scan": 3, "ssd_scan_bwd": 5, "rope": 1,
        "rope_bwd": 1}


@pytest.mark.parametrize("Sq, Sk, causal, window, prefix", [
    (8, 8, True, None, None), (5, 12, True, None, None),
    (12, 12, True, 4, None), (12, 12, True, None, 5),
    (6, 10, False, None, None), (7, 3, True, None, None),
    (16, 16, True, 3, 6)])
def test_visible_pairs_count_the_mask(Sq, Sk, causal, window, prefix):
    """The pairs the plain attention's mask lets through."""
    mask = fa._mask(Sq, Sk, causal, window, prefix, "cpu")
    assert work.visible_pairs(Sq, Sk, causal, window, prefix) == int(
        mask.sum())
    assert np.isclose(work.flash_attention(1, Sq, Sk, 1, 1, 1, F32,
                                           causal=causal, window=window,
                                           prefix_len=prefix).flops,
                      4 * int(mask.sum()))
