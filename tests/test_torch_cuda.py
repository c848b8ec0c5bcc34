"""The port's CUDA kernels and trainer on the card. Every test here needs
a CUDA device and skips without one (marker ``gpu``); this module imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import replay_ops as rops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd_scan as ssd

pytestmark = pytest.mark.gpu

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rops.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.parametrize("cap,n,ptr,width,lo,rows_local", [
    (16, 5, 3, 3, None, 16),
    (13, 8, 9, 3, None, 13),        # wraps at the ring end mid-batch
    (13, 13, 12, 1, None, 13),      # full-capacity write
    (32, 12, 28, 3, 8, 8),          # a window of a wrapping write
    (262_144, 512, 262_000, 3, None, 262_144),
])
def test_ring_write_kernel_matches_plain(dev, cap, n, ptr, width, lo,
                                         rows_local):
    g = torch.Generator(device=dev).manual_seed(cap + ptr)
    data = torch.randn((rows_local, width), generator=g, device=dev)
    batch = torch.randn((n, width), generator=g, device=dev)
    p = torch.tensor(ptr, dtype=torch.int32, device=dev)
    kw = {} if lo is None else {
        "capacity": cap,
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.ring_write(data.clone(), batch, p, **kw)
    want = rops.ring_write_ref(data.clone(), batch, p, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rops.LAUNCH_COUNTS["ring_write"] == 1


# Pendulum's six replay fields (widths 3, 1, 1, 3, 1, 1), then the
# priorities' (capacity, 1) view and a field of (2, 3) rows
FIELD_ROWS = [(3,), (1,), (), (3,), (), (), (1,), (2, 3)]


@pytest.mark.parametrize("cap,n,ptr,fields,lo,rows_local", [
    (40, 12, 5, 6, None, 40),
    (13, 8, 9, 7, None, 13),            # wraps mid-batch, 7 fields
    (13, 13, 12, 8, None, 13),          # n == capacity, 8 fields
    (32, 12, 22, 7, 24, 8),             # a window of a wrapping write
    (262_144, 512, 100_000, 6, None, 262_144),   # a round, mid-ring
    (262_144, 512, 262_000, 7, None, 262_144),   # a PER round, wrapping
    (262_144, 512, 131_072 - 300, 7, 131_072, 65_536),  # straddles a window
])
def test_ring_write_fields_kernel_matches_plain(dev, cap, n, ptr, fields,
                                                lo, rows_local):
    """Every field of a write in one launch, bit for bit, mixed widths."""
    g = torch.Generator(device=dev).manual_seed(cap + ptr + fields)
    datas = [torch.randn((rows_local,) + r, generator=g, device=dev)
             for r in FIELD_ROWS[:fields]]
    batches = [torch.randn((n,) + r, generator=g, device=dev)
               for r in FIELD_ROWS[:fields]]
    p = torch.tensor(ptr, dtype=torch.int32, device=dev)
    kw = {} if lo is None else {
        "capacity": cap,
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.ring_write_fields([d.clone() for d in datas], batches, p,
                                 **kw)
    want = rops.ring_write_fields_ref([d.clone() for d in datas], batches,
                                      p, **kw)
    for gd, wd, d in zip(got, want, datas):
        torch.testing.assert_close(gd, wd, rtol=0, atol=0)
        assert not torch.equal(gd, d)
    assert rops.LAUNCH_COUNTS["ring_write"] == 1


@pytest.mark.parametrize("rows,lo", [(37, None), (16, 10),
                                     (262_144, None)])
def test_ring_gather_kernel_matches_plain(dev, rows, lo):
    g = torch.Generator(device=dev).manual_seed(rows)
    base = lo or 0
    data = torch.randn((rows, 3), generator=g, device=dev)
    idx = torch.cat([
        torch.randint(base, base + rows, (300,), generator=g, device=dev),
        torch.tensor([-1, base - 1, base + rows, 2 * (base + rows)],
                     device=dev)]).to(torch.int32)
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.ring_gather(data, idx, **kw)
    torch.testing.assert_close(got, rops.ring_gather_ref(data, idx, **kw),
                               rtol=0, atol=0)
    assert not got[-4:].any()
    assert rops.LAUNCH_COUNTS["ring_gather"] == 1


# Pendulum's six replay fields as the trainer keeps them (rew, done and
# disc 1-d), the PER priority mass (1-d) and a field of (2, 3) rows
GATHER_ROWS = [(3,), (1,), (), (3,), (), (), (), (2, 3)]


@pytest.mark.parametrize("rows,lo,fields", [
    (37, None, 6), (16, 10, 7), (100, None, 8),
    (262_144, None, 6),                 # an update's gather
    (262_144, None, 7),                 # a PER update's, the mass added
    (65_536, 131_072, 7),               # a window of the ring
])
def test_ring_gather_fields_kernel_matches_plain(dev, rows, lo, fields):
    """Every field of an update's gather in one launch, bit for bit, mixed
    row shapes; out-of-window rows (-1 padding included) zero."""
    g = torch.Generator(device=dev).manual_seed(rows + fields)
    base = lo or 0
    datas = [torch.randn((rows,) + r, generator=g, device=dev)
             for r in GATHER_ROWS[:fields]]
    idx = torch.cat([
        torch.randint(base, base + rows, (8192 if rows > 1000 else 300,),
                      generator=g, device=dev),
        torch.tensor([-1, base - 1, base + rows, 2 * (base + rows)],
                     device=dev)]).to(torch.int32)
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.ring_gather_fields(datas, idx, **kw)
    want = rops.ring_gather_fields_ref(datas, idx, **kw)
    assert len(got) == fields
    for gd, wd, d in zip(got, want, datas):
        assert gd.shape == (idx.shape[0],) + d.shape[1:]
        torch.testing.assert_close(gd, wd, rtol=0, atol=0)
        assert gd[:-4].any() and not gd[-4:].any()
    assert rops.LAUNCH_COUNTS["ring_gather"] == 1


def test_ring_gather_of_no_rows_launches_nothing(dev):
    """An empty idx gives each field's (0,) + row outputs and no launch,
    through both gathers."""
    datas = [torch.randn((16,) + r, device=dev) for r in GATHER_ROWS]
    idx = torch.zeros(0, dtype=torch.int32, device=dev)
    got = rops.ring_gather_fields(datas, idx)
    assert [tuple(x.shape) for x in got] == [(0,) + r for r in GATHER_ROWS]
    assert rops.ring_gather_rowloop(datas[0], idx).shape == (0, 3)
    torch.cuda.synchronize()
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def test_kernel_wrappers_validate_operands(dev):
    data = torch.zeros((8, 3), device=dev)
    ptr = torch.zeros((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="capacity"):
        rops.ring_write(data, torch.zeros((9, 3), device=dev), ptr)
    with pytest.raises(ValueError, match="contiguous"):
        rops.ring_write(data, torch.zeros((3, 2), device=dev).t(), ptr)
    with pytest.raises(TypeError):
        rops.ring_gather(data, torch.zeros(4, dtype=torch.int64,
                                           device=dev))
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


@pytest.mark.parametrize("pool,rows", [((8, 2, 3), (3, 6)),
                                       ((8, 3, 1), (3, 3)),
                                       ((8, 2, 3), (3, 3, 2))])
def test_ring_write_row_shape_mismatch_raises(dev, pool, rows):
    """Rows of another shape but the same width are refused by every
    ring-write wrapper, as the plain versions refuse them."""
    ptr = torch.zeros((), dtype=torch.int32, device=dev)
    data, batch = (torch.zeros(pool, device=dev),
                   torch.ones(rows, device=dev))
    with pytest.raises(RuntimeError, match="do not match"):
        rops.ring_write(data, batch, ptr)
    with pytest.raises(RuntimeError, match="do not match"):
        rops.ring_write_rowloop(data, batch, ptr)
    with pytest.raises(RuntimeError, match="do not match"):
        rops.ring_write_fields([torch.zeros(8, device=dev), data],
                               [torch.ones(3, device=dev), batch], ptr)
    assert not data.any()
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def _pool(dev, rows, live, seed, ties=()):
    """Priorities with ``live`` written rows (a tenth of them zeroed) and
    a Gumbel field; rows in ``ties`` (every row for ``"all"``) share one
    priority and one Gumbel value among the best scores."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pri = torch.zeros(rows, device=dev)
    pri[:live] = torch.rand(live, generator=g, device=dev) * 5 + 1e-3
    pri[torch.rand(rows, generator=g, device=dev) < 0.1] = 0.0
    u = torch.rand(rows, generator=g, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    if ties:
        t = (torch.arange(rows, device=dev) if ties == "all"
             else torch.tensor(ties, device=dev))
        pri[t], gumbel[t] = 4.0, 30.0
    return pri, gumbel


@pytest.mark.parametrize("rows,k,live,lo,ties", [
    (256, 1, 256, None, ()),
    (1000, 64, 40, None, ()),            # fewer live rows than k
    (4096, 4096, 4096, None, ()),        # k = rows, one tile
    (4097, 4097, 4097, None, ()),        # two tiles, k above a tile
    (9000, 300, 9000, 7, (5, 4095, 4096, 8191, 8999)),  # ties over tiles
    (65_536, 8192, 65_536, 131_072, ()),  # a window
    (262_144, 8192, 262_144, None, ()),   # the training path's shapes
    (262_144, 8192, 5000, None, ()),
    (262_144, 8192, 262_144, None, "all"),   # one finite score everywhere
    # 16,384 tied rows at the best score: the k-th key among them
    (262_144, 8192, 262_144, None, tuple(range(3, 262_144, 16))),
    (65_536, 1, 65_536, None, ()),
    (65_536, 65_536, 65_536, None, ()),       # k = rows
    (65_536, 8192, 5000, 131_072, ()),        # a window, fewer live than k
])
def test_per_topk_kernel_matches_plain(dev, rows, k, live, lo, ties):
    """Bit for bit, scores and indices; tied rows win lowest row first."""
    pri, gumbel = _pool(dev, rows, live, rows + k, ties)
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.per_topk(pri, gumbel, 0.6, k, **kw)
    want = rops.per_topk_ref(pri, gumbel, 0.6, k, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    if ties:
        tied = range(rows) if ties == "all" else ties
        n = min(len(tied), k)
        assert got[1][:n].tolist() == [i + (lo or 0) for i in tied[:n]]
    assert rops.LAUNCH_COUNTS["per_topk"] == 1


def test_per_topk_launches_three_device_ops(dev):
    """At the training path's shapes (rows 262,144, k 8,192) a call puts
    at most three ops on the device, counted under torch.profiler, and
    repeated calls agree (the kernels' state is left zeroed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pri, gumbel = _pool(dev, 262_144, 262_144, 24)
    want = rops.per_topk(pri, gumbel, 0.6, 8192)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            got = rops.per_topk(pri, gumbel, 0.6, 8192)
        torch.cuda.synchronize()
    ops = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    assert ops <= 3 * 4
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rows,lo,k,kind", [
    pytest.param(48, None, 8192, "mixed", id="48-None"),
    pytest.param(48, 16, 8192, "mixed", id="48-16"),
    pytest.param(262_144, None, 8192, "mixed", id="262144-None"),
    pytest.param(4096, None, 8192, "one_row", id="one_row"),
    pytest.param(4096, None, 1, "in_window", id="k1"),
    pytest.param(262_144, None, 1000, "in_window", id="k_ragged"),
    pytest.param(262_144, None, 65_536, "in_window", id="k65536"),
    pytest.param(65_536, 131_072, 8192, "straddle", id="straddle"),
])
def test_priority_scatter_kernel_matches_plain(dev, rows, lo, k, kind):
    """Bit for bit: repeated indices (the last write wins) and
    out-of-window ones; all draws on one row, a single draw, k not a
    multiple of a block's threads, k 65,536 over a 262,144-row pool, and
    draws that straddle a window on both sides."""
    g = torch.Generator(device=dev).manual_seed(rows)
    base = lo or 0
    pri = torch.rand(rows, generator=g, device=dev)
    if kind == "one_row":
        idx = torch.full((k,), 17, device=dev)
    elif kind == "straddle":
        idx = torch.randint(base - 4096, base + rows + 4096, (k,),
                            generator=g, device=dev)
    else:
        idx = torch.randint(base, base + rows, (k,), generator=g,
                            device=dev)
    if kind == "mixed":
        idx = torch.cat([idx, torch.tensor(
            [base - 1, base + rows, -1, base + 3, base + 3], device=dev)])
    idx = idx.to(torch.int32)
    vals = torch.rand(idx.shape[0], generator=g, device=dev) * 9
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.priority_scatter(pri.clone(), idx, vals, **kw)
    want = rops.priority_scatter_ref(pri.clone(), idx, vals, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    last_row = {"mixed": 3, "one_row": 17}.get(kind)
    if last_row is not None:
        assert float(got[last_row]) == float(vals[-1])
    assert rops.LAUNCH_COUNTS["priority_scatter"] == 1


def test_per_kernel_wrappers_validate_operands(dev):
    pri = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="k=17"):
        rops.per_topk(pri, pri, 0.6, 17)
    with pytest.raises(TypeError):
        rops.per_topk(pri, pri.double(), 0.6, 4)
    with pytest.raises(ValueError, match="differ"):
        rops.priority_scatter(pri, torch.zeros(3, dtype=torch.int32,
                                               device=dev),
                              torch.zeros(4, device=dev))
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def test_megastep_on_the_card_goes_through_the_kernels(dev):
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP
    cfg = SpreezeConfig(num_envs=4, chunk_len=8, batch_size=64,
                        replay_capacity=100, warmup_frames=64,
                        updates_per_round=2, rounds_per_dispatch=2,
                        hp=AlgoHP(hidden=(32, 32)))
    tr = SpreezeTrainer(cfg)
    tr._warmup()
    rops.reset_launch_counts()
    metrics = tr.megastep()
    # one ring-write launch a round and one gather launch an update, each
    # for all six fields
    assert dict(rops.LAUNCH_COUNTS) == {"ring_write": 2,
                                        "ring_gather": 2 * 2}
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert int(tr.replay.ptr) == (64 + 64) % 100


def _small_trainer(**kw):
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP
    cfg = SpreezeConfig(num_envs=4, chunk_len=8, batch_size=64,
                        replay_capacity=256, warmup_frames=64,
                        updates_per_round=2, rounds_per_dispatch=2,
                        eval_episodes=4, hp=AlgoHP(hidden=(64, 64)), **kw)
    tr = SpreezeTrainer(cfg)
    tr._warmup()
    return tr


def _on_a_thread(fn, *args):
    """``fn(*args)`` on a thread of its own (as the async runtime runs
    its workers); returns its result."""
    import threading
    out = {}
    worker = threading.Thread(target=lambda: out.update(ret=fn(*args)))
    worker.start()
    worker.join(120)
    assert not worker.is_alive() and "ret" in out
    return out["ret"]


def test_snapshot_cloned_before_a_megastep_keeps_the_pre_step_actor(dev):
    """The megastep updates the actor in place; a snapshot cloned before
    it (on the train stream, before the Adam steps) keeps the pre-step
    values bit for bit. The ``overlap_eval`` copy a megastep returns is
    the actor at its end, and the next megastep leaves it alone."""
    from repro_torch._tree import tree_leaves
    tr = _small_trainer(overlap_eval=True)
    before = [p.cpu() for p in tree_leaves(tr.state.actor)]
    snap = tr._snapshot_actor()
    tr.megastep()
    overlap = tr.last_metrics["actor_snapshot"]
    at_end = [p.cpu() for p in tree_leaves(tr.state.actor)]
    tr.megastep()
    torch.cuda.synchronize()
    live = [p.cpu() for p in tree_leaves(tr.state.actor)]
    for got, want in zip(tree_leaves(snap.params), before):
        assert torch.equal(got.cpu(), want)
    assert any(not torch.equal(a, b) for a, b in zip(before, at_end))
    for got, want in zip(tree_leaves(overlap.params), at_end):
        assert torch.equal(got.cpu(), want)
    assert any(not torch.equal(a, b) for a, b in zip(at_end, live))
    assert snap.ready is not None and overlap.ready.query()


def test_async_eval_on_its_stream_equals_inline(dev):
    """The eval worker's result for a snapshot, on its own thread and
    CUDA stream while the train stream goes on updating the live actor,
    equals the inline eval of the same weights and round (relative 1e-6:
    the same kernels on the same inputs)."""
    tr = _small_trainer()
    tr.megastep()
    inline = tr.evaluate(tr.state.actor, 3)
    snap = tr._snapshot_actor()
    tr.megastep()
    got = _on_a_thread(tr._eval_worker_fn, snap, 3)
    assert got == pytest.approx(inline, rel=1e-6)
    ssd = _on_a_thread(tr._ssd_materialize, snap)
    assert _on_a_thread(tr._eval_worker_fn, ssd, 3) == pytest.approx(
        inline, rel=1e-6)


def test_worker_host_read_waits_for_its_own_stream_only(dev):
    """A worker's ``float(...)`` synchronises its own stream: with the
    train stream spinning for about a second, the eval worker returns
    while that work is still running."""
    tr = _small_trainer()
    snap = tr._snapshot_actor()
    _on_a_thread(tr._eval_worker_fn, snap, 0)      # warm up the worker
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)               # ~1 s on the train stream
    spun = torch.cuda.Event()
    spun.record()
    _on_a_thread(tr._eval_worker_fn, snap, 1)
    still_busy = not spun.query()
    torch.cuda.synchronize()
    assert still_busy, "the eval worker waited for the train stream"


def test_per_megastep_on_the_card_goes_through_the_kernels(dev):
    """Per round one ring-write launch (6 fields + priorities); per update
    one gather launch (6 fields + the priority mass), one top-k, one
    scatter."""
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP
    cfg = SpreezeConfig(num_envs=4, chunk_len=8, batch_size=64,
                        replay_capacity=100, warmup_frames=64,
                        updates_per_round=2, rounds_per_dispatch=2,
                        prioritized=True, hp=AlgoHP(hidden=(32, 32)))
    tr = SpreezeTrainer(cfg)
    tr._warmup()
    rops.reset_launch_counts()
    metrics = tr.megastep()
    assert dict(rops.LAUNCH_COUNTS) == {"ring_write": 2,
                                        "ring_gather": 2 * 2,
                                        "per_topk": 2 * 2,
                                        "priority_scatter": 2 * 2}
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert bool((tr.replay.priorities > 0).all())
    assert float(tr.replay.max_priority) >= 1.0


@pytest.mark.parametrize("algo,prioritized", [("td3", False),
                                               ("ddpg", True)])
def test_td3_ddpg_megastep_on_the_card_goes_through_the_kernels(
        dev, algo, prioritized):
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP
    cfg = SpreezeConfig(algo=algo, num_envs=4, chunk_len=8, batch_size=64,
                        replay_capacity=100, warmup_frames=64,
                        updates_per_round=2, rounds_per_dispatch=2,
                        prioritized=prioritized, hp=AlgoHP(hidden=(32, 32)))
    tr = SpreezeTrainer(cfg)
    tr._warmup()
    rops.reset_launch_counts()
    metrics = tr.megastep()
    expect = {"ring_write": 2, "ring_gather": 2 * 2}
    if prioritized:
        expect.update(per_topk=2 * 2, priority_scatter=2 * 2)
    assert dict(rops.LAUNCH_COUNTS) == expect
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert int(tr.state.step) == 4 and tr.state.opt_alpha is None


# --------------------------------------------------------------------------- #
# the bench baselines: the score pass and the row-at-a-time ring kernels
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rows", [1, 100, 1000, 4097, 262_144, 1_000_003])
def test_per_scores_kernel_matches_plain(dev, rows):
    """Bit for bit, zeros (-inf) and p below the 1e-12 floor included;
    row counts that are not a multiple of four end in a ragged tail."""
    g = torch.Generator(device=dev).manual_seed(rows)
    pri = torch.rand(rows, generator=g, device=dev) * 5
    pri[torch.rand(rows, generator=g, device=dev) < 0.5] = 0.0
    pri[::7] = 1e-13
    u = torch.rand(rows, generator=g, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    got = rops.per_scores(pri, gumbel, 0.6)
    want = rops.per_scores_ref(pri, gumbel, 0.6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(torch.isneginf(got), pri == 0)
    assert rops.LAUNCH_COUNTS["per_scores"] == 1


def test_per_scores_kernel_unaligned_matches_plain(dev):
    """Vectors that start off a 16-byte boundary take the kernel's one
    row a thread path, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(5)
    base = torch.rand(10_001, generator=g, device=dev) * 5
    base[::5] = 0.0
    pri = base[1:]
    gumbel = torch.randn(10_003, generator=g, device=dev)[3:]
    got = rops.per_scores(pri, gumbel, 0.6)
    torch.testing.assert_close(got, rops.per_scores_ref(pri, gumbel, 0.6),
                               rtol=0, atol=0)
    assert rops.LAUNCH_COUNTS["per_scores"] == 1


@pytest.mark.parametrize("cap,n,ptr,row", [
    (16, 5, 3, (3,)),
    (13, 8, 9, (3,)),               # wraps at the ring end mid-batch
    (13, 13, 12, ()),               # n == capacity
    (10, 4, 8, (2, 3)),             # trailing dims
    (10, 3, -1, (1,)),              # a negative ptr wraps
    (10, 3, 25, (1,)),              # ptr past the capacity
    (262_144, 512, 262_000, (3,)),  # a round's write, wrapping
    (16_384, 1024, 15_872, (16,)),  # the bench's full preset
])
def test_ring_write_rowloop_kernel_matches_plain(dev, cap, n, ptr, row):
    g = torch.Generator(device=dev).manual_seed(cap + n)
    data = torch.randn((cap,) + row, generator=g, device=dev)
    batch = torch.randn((n,) + row, generator=g, device=dev)
    p = torch.tensor(ptr, dtype=torch.int32, device=dev)
    got = rops.ring_write_rowloop(data.clone(), batch, p)
    want = rops.ring_write_ref(data.clone(), batch, p)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rops.LAUNCH_COUNTS["ring_write_rowloop"] == 1


@pytest.mark.parametrize("rows,row,bsz", [(10, (2,), 64), (37, (), 300),
                                          (16, (2, 3), 64),
                                          (262_144, (3,), 8192)])
def test_ring_gather_rowloop_kernel_matches_plain(dev, rows, row, bsz):
    """Repeats, 0, rows - 1, and indices outside the pool (taken from the
    end once when negative, then clamped)."""
    g = torch.Generator(device=dev).manual_seed(rows)
    data = torch.randn((rows,) + row, generator=g, device=dev)
    idx = torch.cat([
        torch.randint(0, rows, (bsz,), generator=g, device=dev),
        torch.tensor([0, rows - 1, rows - 1, rows + 2, -3, -rows - 3,
                      2**31 - 1, -2**31], device=dev)]).to(torch.int32)
    got = rops.ring_gather_rowloop(data, idx)
    torch.testing.assert_close(got, rops.ring_gather_rowloop_ref(data, idx),
                               rtol=0, atol=0)
    assert torch.equal(got[-5:], data[[rows - 1, rows - 3, 0, rows - 1,
                                       0]])
    assert rops.LAUNCH_COUNTS["ring_gather_rowloop"] == 1


def test_baseline_wrappers_validate_operands(dev):
    data = torch.zeros((8, 3), device=dev)
    ptr = torch.zeros((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="capacity"):
        rops.ring_write_rowloop(data, torch.zeros((9, 3), device=dev), ptr)
    with pytest.raises(TypeError):
        rops.ring_write_rowloop(data, torch.zeros((2, 3), device=dev,
                                                  dtype=torch.float64), ptr)
    with pytest.raises(TypeError):
        rops.ring_gather_rowloop(data.double(), torch.zeros(
            4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="at least one"):
        rops.ring_gather_rowloop(torch.zeros((0, 3), device=dev),
                                 torch.zeros(4, dtype=torch.int32,
                                             device=dev))
    with pytest.raises(ValueError, match="one"):
        rops.per_scores(torch.ones(8, device=dev), torch.ones(9, device=dev),
                        0.6)
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


# --------------------------------------------------------------------------- #
# the LM model kernels
# --------------------------------------------------------------------------- #

def assert_kernel_close(got, want):
    """float32: the reduction order differs, so |got - want| <= 1e-5.
    bfloat16: within one bf16 rounding step of the plain result
    (2**-7 relative), plus the same float32 allowance."""
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 896), (8192, 896), (3, 17, 64),
                                   (5, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn(shape[-1:], generator=g, device=dev)
    assert_kernel_close(rms.rmsnorm(x, w), rms.rmsnorm_ref(x, w))
    assert rops.LAUNCH_COUNTS["rmsnorm"] == 1


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal,window", [
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 100, 100, 14, 2, 64, True, None),     # tail, G = 7
    (1, 40, 130, 6, 2, 64, True, None),       # Sq < Sk
    (2, 96, 96, 4, 2, 16, True, 32),          # sliding window
    (1, 200, 200, 4, 1, 64, True, 64),        # window over several tiles
    (1, 33, 33, 2, 2, 8, False, None),        # non-causal
    (1, 20, 30, 4, 2, 64, False, 16),         # window, non-causal
    (1, 50, 50, 3, 1, 128, True, None),       # head_dim 128
    (1, 70, 30, 2, 1, 32, True, None),        # Sq > Sk: rows see no key
    (1, 150, 150, 4, 2, 80, True, None),      # d 80: not a power of two
    (1, 140, 140, 4, 2, 96, True, None),      # d 96: rows of 12 chunks
    (1, 130, 130, 4, 2, 33, True, None),      # d 33: unaligned rows
    (1, 300, 300, 16, 1, 64, True, None),     # G = 16 over several tiles
    (1, 2048, 2048, 4, 2, 64, True, None),    # long: many rescales
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Sk, H, KV, d,
                                              causal, window, dtype):
    g = torch.Generator(device=dev).manual_seed(Sq * H + d)
    q = torch.randn((B, Sq, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    got = fa.flash_attention(q, k, v, **kw)
    assert_kernel_close(got, fa.attention_ref(q, k, v, **kw))
    assert bool(torch.isfinite(got).all())
    assert rops.LAUNCH_COUNTS["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_holds_a_peaked_softmax(dev, dtype):
    """q times 8 (a power of two: exact in bf16): probabilities over many
    binades, the case the bf16 kernel's two-part P must hold."""
    g = torch.Generator(device=dev).manual_seed(512 * 4 + 64)
    q = torch.randn((1, 512, 4, 64), generator=g, device=dev).to(dtype) * 8
    k = torch.randn((1, 512, 2, 64), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 512, 2, 64), generator=g, device=dev).to(dtype)
    got = fa.flash_attention(q, k, v)
    assert_kernel_close(got, fa.attention_ref(q, k, v))
    assert bool(torch.isfinite(got).all())
    assert rops.LAUNCH_COUNTS["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_an_unaligned_base(dev, dtype):
    """Contiguous operands whose data starts one element past a 16-byte
    boundary: the bf16 kernel loads them element by element."""
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = ((1, 130, 4, 64), (1, 130, 2, 64), (1, 130, 2, 64))
    q, k, v = (torch.randn(1 + s[1] * s[2] * s[3], generator=g,
                           device=dev).to(dtype)[1:].view(s)
               for s in shapes)
    assert all(a.data_ptr() % 16 for a in (q, k, v))
    assert_kernel_close(fa.flash_attention(q, k, v),
                        fa.attention_ref(q, k, v))
    assert rops.LAUNCH_COUNTS["flash_attention"] == 1


@pytest.mark.parametrize("B,S,H,KV,d,vl", [
    (2, 128, 4, 2, 32, 128),
    (1, 100, 3, 1, 16, 77),          # partial cache, odd length
    (8, 1088, 14, 2, 64, 1030),      # the serving shape, several splits
    (1, 64, 2, 2, 8, 1),             # first decode step
    (1, 96, 15, 5, 32, 50),
    (2, 600, 16, 1, 128, 600),       # the largest group and head_dim
    (1, 100, 4, 2, 64, 150),         # valid_len past S is clamped
    (1, 300, 4, 2, 64, 0),           # nothing valid: zeros, no NaN
    (8, 1088, 32, 32, 64, 1030),     # zamba2-1.2b's serving shape, G 1
    (2, 300, 4, 4, 128, 300),        # G 1 at d 128
    (1, 200, 6, 2, 80, 190),         # d 80: 10 of a row's 16 lanes load
    (2, 150, 4, 2, 33, 140),         # d 33: element loads
    # on the H100's 132 SMs qwen2's serving cache splits into 48 slots
    (8, 1088, 14, 2, 64, 241),       # ends in split 5's first warp tile
    (8, 1088, 14, 2, 64, 48),        # exactly one split
    (8, 32_768, 14, 2, 64, 32_768),  # decode_32k at G 7
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(dev, B, S, H, KV, d, vl,
                                               dtype):
    g = torch.Generator(device=dev).manual_seed(S + vl)
    q = torch.randn((B, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, d), generator=g, device=dev).to(dtype)
    valid = torch.tensor(vl, dtype=torch.int32, device=dev)
    got = dec.decode_attention(q, k, v, valid)
    assert_kernel_close(got, dec.decode_attention_ref(q, k, v, valid))
    assert bool(torch.isfinite(got).all())
    assert rops.LAUNCH_COUNTS["decode_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_takes_an_unaligned_base(dev, dtype):
    """Contiguous caches whose data starts one element past a 16-byte
    boundary: the kernel loads them element by element."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, H, KV, d = 2, 300, 14, 2, 64
    q = torch.randn((B, H, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn(1 + B * S * KV * d, generator=g,
                        device=dev).to(dtype)[1:].view(B, S, KV, d)
            for _ in range(2))
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    valid = torch.tensor(290, dtype=torch.int32, device=dev)
    assert_kernel_close(dec.decode_attention(q, k, v, valid),
                        dec.decode_attention_ref(q, k, v, valid))
    assert rops.LAUNCH_COUNTS["decode_attention"] == 1


def test_model_kernel_wrappers_validate_operands(dev):
    x = torch.ones((4, 8), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm(x.cpu(), torch.ones(8))
    with pytest.raises(TypeError):
        rms.rmsnorm(x.half(), torch.ones(8, device=dev))
    q = torch.ones((1, 4, 2, 8), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.ones((1, 4, 3, 8), device=dev),
                           torch.ones((1, 4, 3, 8), device=dev))
    with pytest.raises(TypeError):
        dec.decode_attention(q[:, 0], q, q, torch.tensor(1, device=dev))
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def test_serving_on_the_card_matches_the_cpu(dev):
    """Reduced qwen2-0.5b at float32 compute, the same parameters and
    prompts: prefill plus 6 decode steps give the same tokens on the card
    (kernels) as on the CPU (plain versions), through the kernels."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve.engine import greedy_generate
    cfg = get_config("qwen2-0.5b").reduced()
    shape = InputShape("s", seq_len=24, global_batch=2, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(1))
    want = greedy_generate(rc, params, batch, 24, 6)
    rops.reset_launch_counts()
    got = greedy_generate(rc, tree_map(lambda a: a.to(dev), params),
                          {"tokens": batch["tokens"].to(dev)}, 24, 6)
    assert torch.equal(got.cpu(), want)
    L = cfg.num_layers
    assert dict(rops.LAUNCH_COUNTS) == {"rmsnorm": (2 * L + 1) * 7,
                                        "flash_attention": L,
                                        "decode_attention": L * 6}


# --------------------------------------------------------------------------- #
# the SSD scan, and serving the ssm and hybrid families
# --------------------------------------------------------------------------- #

def assert_scan_close(got, want):
    """The scan sums products over N and the chunk in another order than
    the plain version's cuBLAS products: float32 within 1e-5 of the
    largest |want|; bfloat16 (one rounding of y and the state on each
    side) within one bf16 rounding step (2**-7 relative) more."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    atol = 1e-5 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (2, 96, 3, 8, 32, 32),
    (1, 256, 2, 64, 64, 64),
    (1, 100, 2, 64, 32, 256),        # one ragged chunk
    (1, 512, 3, 64, 128, 256),       # mamba2's P, N and chunk
    (2, 512, 2, 128, 128, 128),      # the largest P and N
    (1, 300, 2, 100, 100, 300 // 2),  # P, N not multiples of 16
    (1, 2048, 2, 64, 128, 256),      # 8 chunks: mamba2's P, N, chunk
    (2, 2048, 3, 64, 64, 256),       # 8 chunks: zamba2's
    (1, 1024, 2, 64, 128, 64),       # 16 chunks of one tile
    (1, 1024, 3, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(dev, B, S, H, P, N, chunk, dtype):
    g = torch.Generator(device=dev).manual_seed(S * H + N)
    x = (torch.randn((B, S, H, P), generator=g, device=dev) * 0.5).to(dtype)
    dtA = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev)) * 0.3
    Bm = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn((B, S, H, N), generator=g, device=dev) * 0.5).to(dtype)
    y, fin = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=chunk)
    wy, wfin = ssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=chunk)
    assert_scan_close(y, wy)
    assert_scan_close(fin, wfin)
    assert rops.LAUNCH_COUNTS["ssd_scan"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_takes_an_unaligned_base(dev, dtype):
    """x, B_ and C_ one element past a 16-byte boundary: the kernels load
    element by element and agree with the plain version."""
    B, S, H, P, N, chunk = 1, 512, 2, 64, 64, 128
    g = torch.Generator(device=dev).manual_seed(7)

    def shifted(shape):
        n = B * S * H * shape
        flat = torch.randn(n + 1, generator=g, device=dev) * 0.5
        return flat.to(dtype)[1:].view(B, S, H, shape)

    x, Bm, Cm = shifted(P), shifted(N), shifted(N)
    dtA = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev)) * 0.3
    assert x.data_ptr() % 16 and Bm.data_ptr() % 16
    y, fin = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=chunk)
    wy, wfin = ssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=chunk)
    assert_scan_close(y, wy)
    assert_scan_close(fin, wfin)


def test_ssd_scan_wrapper_validates_operands(dev):
    x = torch.ones((1, 64, 2, 16), device=dev)
    dtA = -torch.ones((1, 64, 2), device=dev)
    Bm = torch.ones((1, 64, 2, 8), device=dev)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dtA.bfloat16(), Bm, Bm, chunk=64)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.bfloat16(), dtA, Bm, Bm, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dtA,
                     Bm, Bm, chunk=64)
    with pytest.raises(ValueError, match="must divide"):
        ssd.ssd_scan(x, dtA, Bm, Bm, chunk=48)
    # the kernel's limits, from the binding: P and N <= 128, chunk <= 256
    wide = torch.ones((1, 64, 2, 129), device=dev)
    with pytest.raises(RuntimeError, match="P and N"):
        ssd.ssd_scan(wide, dtA, Bm, Bm, chunk=64)
    with pytest.raises(RuntimeError, match="P and N"):
        ssd.ssd_scan(x, dtA, wide, wide, chunk=64)
    S = 512
    with pytest.raises(RuntimeError, match="chunk in"):
        ssd.ssd_scan(torch.ones((1, S, 2, 16), device=dev),
                     -torch.ones((1, S, 2), device=dev),
                     torch.ones((1, S, 2, 8), device=dev),
                     torch.ones((1, S, 2, 8), device=dev), chunk=S)
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def _binding_case(name, dev):
    """A call of a registered op that fails one of the binding's checks
    whose message holds an integer."""
    ops = torch.ops.repro_torch
    f32 = dict(device=dev)
    i32 = dict(device=dev, dtype=torch.int32)
    if name == "ring_write_capacity":
        d = torch.ones((8, 3), **f32)
        return lambda: ops.ring_write([d], [torch.ones((5, 3), **f32)],
                                      torch.zeros(1, **i32), None, 4)
    if name in ("ring_write_fields", "ring_write_no_fields",
                "ring_write_batches", "ring_write_field_rows",
                "ring_write_batch_rows", "ring_write_row_shape"):
        fields = {"ring_write_fields": 9, "ring_write_no_fields": 0}.get(
            name, 2)
        d = [torch.ones((8, 3), **f32) for _ in range(fields)]
        b = [torch.ones((5, 3), **f32) for _ in range(fields)]
        if name == "ring_write_batches":
            b = b[:1]
        if name == "ring_write_field_rows":
            d[1] = torch.ones((7, 3), **f32)
        if name == "ring_write_batch_rows":
            b[1] = torch.ones((4, 3), **f32)
        if name == "ring_write_row_shape":
            b[1] = torch.ones((5, 3, 1), **f32)
        return lambda: ops.ring_write(d, b, torch.zeros(1, **i32), None, 8)
    if name in ("per_topk_k", "per_topk_rows"):
        k = 9 if name == "per_topk_k" else 4
        pri = torch.ones(8, **f32)
        gumbel = pri if name == "per_topk_k" else torch.ones(9, **f32)
        return lambda: ops.per_topk(pri, gumbel, None, 0.6, k)
    if name in ("ring_gather_fields", "ring_gather_no_fields",
                "ring_gather_field_rows"):
        fields = {"ring_gather_fields": 9, "ring_gather_no_fields": 0}.get(
            name, 2)
        d = [torch.ones((8, 3), **f32) for _ in range(fields)]
        if name == "ring_gather_field_rows":
            d[1] = torch.ones((7, 3), **f32)
        return lambda: ops.ring_gather(d, torch.zeros(5, **i32), None)
    if name == "ring_write_rowloop_capacity":
        d = torch.ones((4, 3), **f32)
        return lambda: ops.ring_write_rowloop(d, torch.ones((5, 3), **f32),
                                              torch.zeros(1, **i32))
    if name == "ring_gather_rowloop_rows":
        d = torch.ones((0, 3), **f32)
        return lambda: ops.ring_gather_rowloop(d, torch.zeros(2, **i32))
    if name == "per_scores_rows":
        pri = torch.ones(8, **f32)
        return lambda: ops.per_scores(pri, torch.ones(9, **f32), 0.6)
    if name in ("flash_heads", "flash_head_dim"):
        H, d = (3, 8) if name == "flash_heads" else (2, 256)
        q = torch.ones((1, 4, H, d), **f32)
        kv = torch.ones((1, 4, 2, d), **f32)
        return lambda: ops.flash_attention(q, kv, kv, torch.empty_like(q),
                                           True, None, 0.1)
    if name in ("decode_group", "decode_empty_cache"):
        H, S = (34, 8) if name == "decode_group" else (4, 0)
        q = torch.ones((1, H, 8), **f32)
        kv = torch.ones((1, S, 2, 8), **f32)
        return lambda: ops.decode_attention(q, kv, kv, torch.ones(1, **i32),
                                            torch.empty_like(q), 0.1)
    S, P, chunk = (64, 129, 64) if name == "ssd_dims" else (512, 16, 512)
    x = torch.ones((1, S, 2, P), **f32)
    b = torch.ones((1, S, 2, 8), **f32)
    return lambda: ops.ssd_scan(x, -torch.ones((1, S, 2), **f32), b, b,
                                chunk)


@pytest.mark.parametrize("name", [
    "ring_write_capacity", "ring_write_fields", "ring_write_no_fields",
    "ring_write_batches", "ring_write_field_rows", "ring_write_batch_rows",
    "ring_write_row_shape", "per_topk_k", "per_topk_rows", "flash_heads", "flash_head_dim",
    "decode_group", "decode_empty_cache", "ssd_dims", "ssd_chunk",
    "ring_write_rowloop_capacity", "ring_gather_rowloop_rows",
    "per_scores_rows", "ring_gather_fields", "ring_gather_no_fields",
    "ring_gather_field_rows"])
def test_binding_checks_with_numbers_raise(dev, name):
    """Every check in binding.cpp whose message holds an integer raises a
    RuntimeError naming the number: streamed into the message as an
    integer, it crashes the process instead, so ``num`` formats it."""
    from repro_torch.kernels._build import load_kernels
    load_kernels()
    with pytest.raises(RuntimeError, match=r"\d"):
        _binding_case(name, dev)()
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 2),
                                         ("zamba2-1.2b", 5)])
def test_ssm_serving_on_the_card_matches_the_cpu(dev, arch, layers):
    """Reduced mamba2 / zamba2 (groups (0, 2), (2, 4), (4, 5)) at float32
    compute, the same parameters and prompts: prefill (two chunks of 32)
    plus 6 decode steps give the same tokens on the card as on the CPU,
    through the kernels."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve.engine import greedy_generate
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced(num_layers=layers)
    shape = InputShape("s", seq_len=64, global_batch=2, kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(1))
    want = greedy_generate(rc, params, batch, 64, 6)
    rops.reset_launch_counts()
    got = greedy_generate(rc, tree_map(lambda a: a.to(dev), params),
                          {"tokens": batch["tokens"].to(dev)}, 64, 6)
    assert torch.equal(got.cpu(), want)
    L = cfg.num_layers
    n_inv = len(factory._hybrid_groups(cfg)) if cfg.family == "hybrid" \
        else 0
    expect = {"rmsnorm": (2 * L + 1 + 2 * n_inv) * 7, "ssd_scan": L}
    if n_inv:
        expect.update(flash_attention=n_inv, decode_attention=n_inv * 6)
    assert dict(rops.LAUNCH_COUNTS) == expect


def test_sanitize_scope_sets_the_sync_debug_mode_and_restores_it(dev):
    """Inside the scope the sync debug mode is "error" (2), so a host
    read raises; after it the previous mode is back and the read runs."""
    tr = _small_trainer(sanitize=True)
    prev = torch.cuda.get_sync_debug_mode()
    x = torch.ones((), device=dev)
    with tr._sanitize_scope():
        assert torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError):
            x.item()
    assert torch.cuda.get_sync_debug_mode() == prev
    assert x.item() == 1.0


@pytest.mark.parametrize("kw", [dict(), dict(fused=False),
                                dict(transfer="queue", queue_size=128)],
                         ids=["fused", "eager", "queue"])
def test_sanitize_train_on_the_card(dev, kw):
    """A sanitized ``train()`` on the card: no operation of a megastep
    (or of an eager round's two halves, the queue's copies lifted) waits
    for the device, with eval on the async workers."""
    tr = _small_trainer(sanitize=True, eval_every_rounds=2, **kw)
    hist = tr.train(max_seconds=60.0, max_frames=tr.total_frames + 6 * 32)
    assert hist.update_hz > 0 and hist.eval_returns
    assert torch.cuda.get_sync_debug_mode() == 0


def test_draws_state_roundtrips_on_a_cuda_generator(dev):
    """``Draws.get_state()`` on the card is the generator's seed and
    offset (16 bytes on the host); setting it back replays the draws."""
    from repro_torch.core.pipeline import Draws
    from repro_torch.envs import make
    draws = Draws(make("pendulum"), 1, 2, dev)
    draws.sampler_step(4, 1)
    state = draws.get_state()
    assert state.device.type == "cpu" and state.dtype == torch.uint8
    assert state.numel() == 16
    first = draws.sampler_step(4, 1)[0]
    draws.set_state(state)
    assert torch.equal(draws.sampler_step(4, 1)[0], first)


def test_poll_guard_returns_without_a_sync(dev):
    """With the train stream spinning for about a second, the poll reads
    a flag whose event completed before the spin and returns at once,
    the spin still running, leaving the flag queued behind the spin in
    flight; once the stream is idle it returns that flag's round. (The
    flag behind the spin takes three launches: a megastep's thousands
    would fill the card's launch queue, and the host would wait for
    room in it.)"""
    import time
    from repro_torch import sync_debug_mode
    from repro_torch.core import faults
    tr = _small_trainer()
    tr.megastep()
    tr._guard_q.append(tr._guard_entry(0, tr.last_metrics["carry_finite"]))
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    spun = torch.cuda.Event()
    spun.record()
    poisoned = faults.tree_finite(faults.poison_actor(tr.state.actor))
    tr._guard_q.append(tr._guard_entry(4, poisoned))
    t = time.perf_counter()
    with sync_debug_mode(dev, "error"):
        assert tr._poll_guard() is None
    waited = time.perf_counter() - t
    still_busy = not spun.query()
    assert [r for r, _, _ in tr._guard_q] == [4]
    assert still_busy and waited < 0.2, waited
    torch.cuda.synchronize()
    assert tr._poll_guard() == 4 and not tr._guard_q
