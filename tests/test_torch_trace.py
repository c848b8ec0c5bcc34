"""The port's spans and counters (``repro_torch.trace``), on the CPU.

An inactive span keeps nothing and opens no ``record_function``; under
``torch.profiler`` one ``make_arch_spreeze_update`` step of the reduced
smollm-360m (2 layers, d 128, as ``tests/test_torch_arch_rl.py`` builds
it) gives each phase's span once, Adam's twice, a span a kernel call on
the CPU route, and 5 tower forwards; each in-memory record lies within
50 us of the profiler's ``repro.<name>`` event at both ends; ``first``
is timed once with tracing off; a full buffer counts what it turns away;
a span's self time is its duration less its children's.
"""
import statistics
import time

import pytest
import torch

from repro_torch import trace
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.core import model_parallel as mp
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.kernels import ops as kops
from repro_torch.rl import networks as nets
from repro_torch.train.optimizer import make_optimizer

A = 4
ARCH_SPANS = ("arch.update", "arch.critic_loss", "arch.critic_grad",
              "arch.actor_loss", "arch.actor_grad")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _update_and_inputs():
    cfg = get_config("smollm-360m").reduced(num_layers=2, d_model=128)
    gen = torch.Generator().manual_seed(0)
    actor = nets.init_arch_policy(gen, cfg, A)
    q = nets.init_arch_ensemble_q(gen, cfg, A)
    q_target = tree_map(lambda a: a.detach().clone(), q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    opt = make_optimizer("adam", 3e-4)
    update = mp.make_arch_spreeze_update(cfg, opt, A, dtype=torch.float32)
    B, S = 2, 8
    args = (actor, q, q_target, opt.init(actor), opt.init(q),
            torch.randint(0, cfg.vocab_size, (B, S), generator=gen),
            torch.tanh(torch.randn((B, A), generator=gen)),
            torch.randn((B,), generator=gen),
            torch.tensor([0.0, 1.0]), torch.randn((B, A), generator=gen))
    return update, args


def _counting(monkeypatch, name):
    calls = [0]
    inner = getattr(kops, name)

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)
    monkeypatch.setattr(kops, name, counted)
    return calls


def test_an_inactive_span_keeps_nothing_and_opens_no_record_function(
        monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function opened by an inactive span")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b")          # one shared no-op

    @trace.spanned("c")
    def f(x):
        return x + 1
    with trace.span("a"):
        assert f(1) == 2
    assert trace.records() == []
    assert trace.snapshot()["spans"] == {}


def test_one_update_under_the_profiler(monkeypatch):
    update, args = _update_and_inputs()
    norms = _counting(monkeypatch, "rmsnorm")
    flashes = _counting(monkeypatch, "flash_attention")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        update(*args)
    snap = trace.snapshot()
    spans = {k: v["count"] for k, v in snap["spans"].items()}
    for name in ARCH_SPANS:
        assert spans[name] == 1, name
    assert spans["arch.adam"] == 2
    assert norms[0] > 0 and flashes[0] > 0
    assert spans["op.rmsnorm"] == norms[0]
    assert spans["op.flash_attention"] == flashes[0]
    assert spans["op.rmsnorm_bwd"] > 0 and spans["op.flash_attention_bwd"] > 0
    assert snap["counters"] == {"arch.updates": 1,
                                "model.backbone_forwards": 5}
    assert snap["launches"] is LAUNCH_COUNTS
    events = [e.name for e in prof.events()
              if e.name.startswith(trace.PREFIX)]
    for name, n in spans.items():
        assert events.count(trace.PREFIX + name) == n, name
    recs = trace.records()
    assert len({r[2] for r in recs}) == 1 and recs[0][2] is not None
    parents = {r[0]: r[1] for r in recs}
    assert parents["arch.update"] is None
    assert parents["arch.critic_loss"] == "arch.update"
    assert parents["arch.adam"] == "arch.update"


def test_records_lie_on_the_profilers_clock():
    """Each record against the profiler's event of the same span (the
    events' unix times: the trace's start plus their offsets), at both
    ends; the median over the spans of one update, so that a thread
    switch inside one span's bookkeeping does not decide."""
    update, args = _update_and_inputs()
    update(*args)                  # the first update is set-up's
    trace.reset()
    from torch.profiler import ProfilerActivity, profile
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # no pool's spinning threads beside it
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            update(*args)
    finally:
        torch.set_num_threads(threads)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            events.setdefault(e.name[len(trace.PREFIX):], []).append(
                (t0 + 1000 * e.time_range.start, t0 + 1000 * e.time_range.end))
    recs = {}
    for name, _, _, s, t in trace.records():
        recs.setdefault(name, []).append((s, t))
    starts, ends = [], []
    for name, rs in recs.items():
        evs = sorted(events[name])
        assert len(evs) == len(rs), name
        for (s, t), (es, et) in zip(sorted(rs), evs):
            starts.append(abs(s - es))
            ends.append(abs(t - et))
    assert len(starts) > 20
    assert statistics.median(starts) < 50e3, sorted(starts)
    assert statistics.median(ends) < 50e3, sorted(ends)


def test_first_is_timed_once_with_tracing_off():
    for pause in (0.02, 0.0):
        with trace.first("test.first"):
            time.sleep(pause)
    got = trace.snapshot()["first"]["test.first"]
    assert 0.02 <= got < 1.0
    assert trace.records() == [] and trace.snapshot()["spans"] == {}
    trace.reset()
    assert trace.snapshot()["first"]["test.first"] == got


def test_first_self_leaves_out_the_first_spans_inside():
    with trace.first("test.outer"):
        time.sleep(0.01)
        with trace.first("test.inner"):
            time.sleep(0.02)
    snap = trace.snapshot()
    assert snap["first_self"]["test.outer"] == pytest.approx(
        snap["first"]["test.outer"] - snap["first"]["test.inner"])
    assert snap["first_self"]["test.inner"] == snap["first"]["test.inner"]


def test_a_full_buffer_counts_what_it_turns_away(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("x"):
            pass
    assert len(trace.records()) == 3
    snap = trace.snapshot()
    assert snap["dropped"] == 2 and snap["spans"]["x"]["count"] == 5
    trace.reset()
    assert trace.snapshot()["dropped"] == 0 and trace.records() == []


def test_self_time_is_the_duration_less_the_childrens():
    trace.enable()
    with trace.span("parent"):
        time.sleep(0.005)
        for _ in range(2):
            with trace.span("child"):
                time.sleep(0.005)
    spans = trace.snapshot()["spans"]
    recs = {}
    for name, parent, _, s, t in trace.records():
        recs.setdefault(name, []).append((parent, t - s))
    (_, dur), = recs["parent"]
    kids = [d for p, d in recs["child"] if p == "parent"]
    assert len(kids) == 2
    assert spans["parent"]["host_s"] == pytest.approx(dur / 1e9)
    assert spans["parent"]["self_s"] == pytest.approx(
        (dur - sum(kids)) / 1e9)
    assert spans["child"]["self_s"] == spans["child"]["host_s"]
    assert 0.004 < spans["parent"]["self_s"] < dur / 1e9


def test_counters_count_with_tracing_off():
    trace.count("test.events")
    trace.count("test.events", 2)
    assert trace.snapshot()["counters"] == {"test.events": 3}
