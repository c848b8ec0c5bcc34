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
    (1, 200, 200, 8, 1, 256, True, None),     # head_dim 256 (paligemma)
    (1, 130, 130, 2, 1, 200, True, None),     # d 200: a padded 256 tile
    (1, 1500, 1500, 4, 4, 64, False, None),   # whisper's encoder tail
    (1, 100, 1500, 4, 4, 64, False, None),    # whisper's cross attention
    (1, 150, 150, 4, 2, 112, True, 64),       # kimi's d 112, a window
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


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,prefix,window", [
    (2, 200, 200, 8, 1, 256, 64, None),       # paligemma's d and G 8
    (1, 150, 150, 4, 2, 64, 100, None),       # prefix ends mid-tile
    (1, 130, 130, 4, 2, 64, 130, None),       # all prefix: bidirectional
    (1, 100, 100, 4, 1, 256, 0, None),        # an empty prefix: causal
    (1, 40, 130, 4, 2, 64, 90, None),         # Sq < Sk
    (1, 200, 200, 4, 2, 64, 70, 32),          # a window over the prefix
    (1, 320, 320, 8, 1, 256, 256, None),      # a 256-token prefix, tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_prefix_matches_plain(dev, B, Sq, Sk, H, KV,
                                                     d, prefix, window,
                                                     dtype):
    """Under the causal mask keys below ``prefix_len`` are visible to
    every query (the VLM prefill's make_mask)."""
    g = torch.Generator(device=dev).manual_seed(Sq + prefix + d)
    q = torch.randn((B, Sq, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    kw = dict(causal=True, window=window, prefix_len=prefix)
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
    (2, 1344, 8, 1, 256, 1300),      # paligemma's d 256, G 8
    (1, 300, 4, 4, 256, 290),        # G 1 at d 256
    (1, 200, 2, 1, 200, 150),        # d 200: lanes past d load zeros
    (1, 150, 2, 2, 136, 149),        # d 136: 17 of a row's 32 lanes load
    (2, 1500, 16, 16, 64, 1500),     # whisper's cross cache, all valid
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


def assert_grad_close(got, want, rel):
    """A backward kernel against its plain version: the sums run over the
    sequence and the G heads in another order, so |got - want| <= rel
    times the largest |want| (float32 1e-4, bf16 1e-2)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * max(scale, 1e-30), (err, scale)


GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("shape", [(8, 896), (3, 17, 64), (5, 33),
                                   (70, 2560), (1, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn(shape[-1:], generator=g, device=dev)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    dx, dw = rms.rmsnorm_bwd(x, w, dy)
    ex, ew = rms.rmsnorm_bwd_ref(x, w, dy)
    assert_grad_close(dx, ex, GRAD_REL[dtype])
    assert_grad_close(dw, ew, GRAD_REL[dtype])
    dx2, dw2 = rms.rmsnorm_bwd(x, w, dy)         # no atomics: same bits
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert rops.LAUNCH_COUNTS["rmsnorm_bwd"] == 2


def test_rmsnorm_function_on_the_card_matches_the_cpu(dev):
    """``ops.rmsnorm`` under autograd: the kernels' gradients on the card
    against the plain versions' on the CPU, one backward launch."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 7, 96), generator=g)
    w = torch.randn((96,), generator=g)
    dy = torch.randn((4, 7, 96), generator=g)
    grads = {}
    for where in ("cpu", dev):
        xs, ws = (t.to(where).requires_grad_() for t in (x, w))
        y = ops.rmsnorm(xs, ws)
        grads[str(where)] = torch.autograd.grad(y, (xs, ws), dy.to(where))
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        assert_grad_close(got.cpu(), want, 1e-4)
    assert dict(rops.LAUNCH_COUNTS) == {"rmsnorm": 1, "rmsnorm_bwd": 1}


# (B, Sq, Sk, H, KV, d, causal, window, prefix_len)
FLASH_BWD_CASES = [
    (2, 64, 64, 4, 2, 32, True, None, None),
    (1, 100, 100, 14, 2, 64, True, None, None),   # tail, G = 7
    (1, 40, 130, 6, 2, 64, True, None, None),     # Sq < Sk
    (1, 200, 200, 4, 1, 64, True, 64, None),      # window over tiles
    (1, 33, 33, 2, 2, 8, False, None, None),      # non-causal
    (1, 20, 30, 4, 2, 64, False, 16, None),       # window, non-causal
    (1, 70, 30, 2, 1, 32, True, None, None),      # Sq > Sk: keyless rows
    (1, 150, 150, 4, 2, 80, True, None, None),    # d 80
    (1, 150, 150, 4, 2, 112, True, 64, None),     # kimi's d 112, window
    (1, 130, 130, 2, 1, 128, True, None, None),   # d 128
    (1, 200, 200, 8, 1, 256, True, None, 64),     # paligemma: d 256, G 8
    (1, 150, 150, 4, 2, 64, True, None, 100),     # prefix ends mid-tile
    (1, 200, 200, 4, 2, 64, True, 32, 70),        # window over the prefix
    (1, 300, 300, 2, 2, 64, False, None, None),   # whisper's encoder
    (1, 100, 300, 2, 2, 64, False, None, None),   # whisper's cross
    (1, 256, 256, 16, 1, 64, True, None, None),   # G = 16
    (2, 100, 100, 4, 2, 40, True, None, None),    # d 40: a padded tile
    (1, 64, 64, 2, 1, 96, True, 3, None),         # d 96, a narrow window
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d,causal,window,prefix",
                         FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, B, Sq, Sk, H, KV, d,
                                                  causal, window, prefix,
                                                  dtype):
    """The forward's LSE (-inf where a row sees no key) and the backward
    kernels' dq, dk, dv against the plain versions, on the same inputs;
    two runs give the same bits."""
    g = torch.Generator(device=dev).manual_seed(Sq * H + d + 7)
    q = torch.randn((B, Sq, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, d), generator=g, device=dev).to(dtype)
    dout = torch.randn((B, Sq, H, d), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want_out, want_lse = fa.attention_ref(q, k, v, return_lse=True, **kw)
    assert_kernel_close(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for a, b in zip(got, want):
        assert_grad_close(a, b, GRAD_REL[dtype])
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert rops.LAUNCH_COUNTS["flash_attention_bwd"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_takes_an_unaligned_base(dev, dtype):
    """Operands one element past a 16-byte boundary: the bf16 backward
    takes its float32 SIMT kernels instead of the tensor-core ones."""
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = ((1, 130, 4, 64), (1, 130, 2, 64), (1, 130, 2, 64),
              (1, 130, 4, 64))
    q, k, v, dout = (torch.randn(1 + s[1] * s[2] * s[3], generator=g,
                                 device=dev).to(dtype)[1:].view(s)
                     for s in shapes)
    assert all(a.data_ptr() % 16 for a in (q, k, v, dout))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    for a, b in zip(got, want):
        assert_grad_close(a, b, GRAD_REL[dtype])


def test_flash_attention_lse_only_when_asked(dev):
    """Serving's call writes no LSE and returns the output alone."""
    q = torch.randn((1, 64, 2, 64), device=dev, dtype=torch.bfloat16)
    out = fa.flash_attention(q, q, q)
    assert isinstance(out, torch.Tensor) and out.shape == q.shape


def test_flash_function_on_the_card_matches_the_cpu(dev):
    """``ops.flash_attention`` under autograd: the kernels' gradients on
    the card against the plain versions' on the CPU (float32, G 3, a
    window), one forward and one backward launch."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 90, 6, 64), generator=g)
    k = torch.randn((2, 90, 2, 64), generator=g)
    v = torch.randn((2, 90, 2, 64), generator=g)
    dout = torch.randn((2, 90, 6, 64), generator=g)
    grads = {}
    for where in ("cpu", dev):
        ts = [t.to(where).requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*ts, window=40)
        grads[str(where)] = torch.autograd.grad(out, ts, dout.to(where))
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        assert_grad_close(got.cpu(), want, 1e-4)
    assert dict(rops.LAUNCH_COUNTS) == {"flash_attention": 1,
                                        "flash_attention_bwd": 1}


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
                                        "rope": L * 7,
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


def _scan_operands(dev, dtype, B, S, H, P, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev) * scale
    x, Bm, Cm = (rnd(B, S, H, n).to(dtype) for n in (P, N, N))
    dtA = -torch.nn.functional.softplus(rnd(B, S, H, scale=1.0)) * 0.3
    s0 = rnd(B, H, P, N)
    dy = rnd(B, S, H, P, scale=1.0).to(dtype)
    dfin = rnd(B, H, P, N, scale=1.0)
    return x, dtA, Bm, Cm, s0, dy, dfin


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 32, 16, 32),
    (2, 80, 4, 32, 32, 256),          # one ragged chunk
    (1, 96, 2, 24, 20, 32),           # P, N not multiples of 16
    (1, 1024, 2, 64, 128, 256),       # mamba2's P, N and chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_from_an_initial_state(dev, B, S, H, P, N, chunk,
                                               dtype):
    """The forward started from a given float32 state, and the chunk-start
    states it hands back, against the plain version; still one launch."""
    x, dtA, Bm, Cm, s0, _, _ = _scan_operands(dev, dtype, B, S, H, P, N, S)
    y, fin, states = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=chunk,
                                  initial_state=s0, return_states=True)
    wy, wfin, wstates = ssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=chunk,
                                         initial_state=s0,
                                         return_states=True)
    assert_scan_close(y, wy)
    assert_scan_close(fin, wfin)
    assert_scan_close(states, wstates)
    assert rops.LAUNCH_COUNTS["ssd_scan"] == 1


def assert_grads_close(got, want, dtype):
    """A backward kernel's gradients against the plain version's: each
    within 1e-4 (float32) or 1e-2 (bf16) of its largest value, as
    chip_smoke's GRAD_TOL (sums over the chunk, the state and the chunks
    in other orders; bf16 outputs rounded once on each side)."""
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), err


@pytest.mark.parametrize("B,S,H,P,N,chunk,init,dfinal", [
    (2, 128, 4, 32, 16, 32, False, False),
    (2, 80, 4, 32, 32, 256, False, True),       # one ragged chunk
    (1, 96, 2, 24, 20, 32, True, True),         # P 24, N 20, three chunks
    (1, 1024, 2, 64, 128, 256, True, False),    # mamba2's P, N and chunk
    (1, 1024, 3, 64, 64, 256, False, False),    # zamba2's
    (1, 512, 2, 128, 128, 128, True, True),     # the largest P and N
    (1, 256, 2, 128, 64, 128, False, True),     # P 128 over N 64
    (1, 512, 2, 100, 72, 64, True, True),       # 8 chunks of one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_matches_plain(dev, B, S, H, P, N, chunk, init,
                                           dfinal, dtype):
    x, dtA, Bm, Cm, s0, dy, dfin = _scan_operands(dev, dtype, B, S, H, P, N,
                                                  S + P + N)
    _, _, states = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=chunk,
                                initial_state=s0 if init else None,
                                return_states=True)
    dfin = dfin if dfinal else None
    got = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, states, dy, dfin, chunk=chunk)
    want = ssd.ssd_scan_bwd_ref(x, dtA, Bm, Cm, states, dy, dfin,
                                chunk=chunk)
    assert_grads_close(got, want, dtype)
    assert rops.LAUNCH_COUNTS["ssd_scan_bwd"] == 1
    # the same bits on a second run: no atomics
    again = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, states, dy, dfin, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_takes_an_unaligned_base(dev, dtype):
    """x, B_, C_ and dy one element past a 16-byte boundary: the bf16
    backward leaves the tensor cores for its element-by-element kernels
    and agrees with the plain version."""
    B, S, H, P, N, chunk = 1, 256, 2, 64, 64, 128
    g = torch.Generator(device=dev).manual_seed(9)

    def shifted(width, scale=0.5):
        flat = torch.randn(B * S * H * width + 1, generator=g,
                           device=dev) * scale
        return flat.to(dtype)[1:].view(B, S, H, width)

    x, Bm, Cm, dy = shifted(P), shifted(N), shifted(N), shifted(P, 1.0)
    dtA = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev)) * 0.3
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    _, _, states = ssd.ssd_scan(x, dtA, Bm, Cm, chunk=chunk,
                                return_states=True)
    got = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, states, dy, chunk=chunk)
    want = ssd.ssd_scan_bwd_ref(x, dtA, Bm, Cm, states, dy, chunk=chunk)
    assert_grads_close(got, want, dtype)


def test_ssd_scan_trains_on_the_card_as_on_the_cpu(dev):
    """``ops.ssd_scan`` under a gradient on the card (``SSDScan``: the
    forward and backward kernels) against the same on the CPU (the plain
    versions), float32, an initial state and a used final state."""
    from repro_torch.kernels import ops
    arrays = _scan_operands(dev, torch.float32, 2, 96, 3, 16, 8, 5)

    def run(where):
        leaves = [a.detach().to(where).requires_grad_()
                  for a in arrays[:5]]
        y, fin = ops.ssd_scan(*leaves[:4], chunk=32,
                              initial_state=leaves[4])
        ((y * arrays[5].to(where)).sum() +
         (fin * arrays[6].to(where)).sum()).backward()
        return [a.grad.cpu() for a in leaves]

    got = run(dev)
    assert rops.LAUNCH_COUNTS["ssd_scan"] == 1
    assert rops.LAUNCH_COUNTS["ssd_scan_bwd"] == 1
    assert_grads_close(got, run("cpu"), torch.float32)


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
    if name in ("flash_heads", "flash_head_dim", "flash_prefix"):
        H, d = (3, 8) if name == "flash_heads" else (2, 264) \
            if name == "flash_head_dim" else (2, 8)
        q = torch.ones((1, 4, H, d), **f32)
        kv = torch.ones((1, 4, 2, d), **f32)
        prefix = 5 if name == "flash_prefix" else None
        return lambda: ops.flash_attention(q, kv, kv, torch.empty_like(q),
                                           True, None, prefix, 0.1)
    if name == "flash_batch":
        q = torch.ones((65536, 1, 1, 8), **f32)
        return lambda: ops.flash_attention(q, q, q, torch.empty_like(q),
                                           True, None, None, 0.1)
    if name in ("flash_lse_shape", "flash_bwd_lse_shape",
                "flash_bwd_prefix", "flash_bwd_heads"):
        H = 3 if name == "flash_bwd_heads" else 2
        q = torch.ones((1, 4, H, 8), **f32)
        kv = torch.ones((1, 4, 2, 8), **f32)
        lse = torch.zeros((1, 2, 5 if "lse" in name else 4), **f32)
        prefix = 5 if name == "flash_bwd_prefix" else None
        if name == "flash_lse_shape":
            return lambda: ops.flash_attention(q, kv, kv, torch.empty_like(q),
                                               True, None, None, 0.1, lse)
        return lambda: ops.flash_attention_bwd(q, kv, kv, q, lse, q, True,
                                               None, prefix, 0.1)
    if name == "rmsnorm_bwd_weight":
        x = torch.ones((3, 8), **f32)
        return lambda: ops.rmsnorm_bwd(x, torch.ones(7, **f32), x, 1e-6)
    if name in ("decode_group", "decode_empty_cache", "decode_head_dim"):
        H, S, d = {"decode_group": (34, 8, 8), "decode_empty_cache": (4, 0, 8),
                   "decode_head_dim": (4, 8, 264)}[name]
        q = torch.ones((1, H, d), **f32)
        kv = torch.ones((1, S, 2, d), **f32)
        return lambda: ops.decode_attention(q, kv, kv, torch.ones(1, **i32),
                                            torch.empty_like(q), 0.1)
    if name in ("rope_head_dim", "rope_positions"):
        d = 24 if name == "rope_head_dim" else 64
        q = torch.ones((1, 4, 2, d), **f32)
        pos = torch.zeros(3 if name == "rope_positions" else 4, **i32)
        return lambda: ops.rope(q, None, pos, None, 1e4, False)
    S, P, chunk = (64, 129, 64) if name.endswith("ssd_dims") else \
        (512, 16, 512) if name.endswith("ssd_chunk") else (64, 16, 32)
    x = torch.ones((1, S, 2, P), **f32)
    b = torch.ones((1, S, 2, 8), **f32)
    dtA = -torch.ones((1, S, 2), **f32)
    if name == "ssd_initial_state":
        return lambda: ops.ssd_scan(x, dtA, b, b, chunk,
                                    torch.zeros((1, 2, P, 7), **f32))
    if name.startswith("ssd_bwd"):
        states = torch.zeros((1, 2, max(S // chunk, 1), P, 8), **f32)
        if name == "ssd_bwd_states":
            states = torch.zeros((1, 2, 3, P, 8), **f32)
        dfin = torch.zeros((1, 2, P, 7 if name == "ssd_bwd_dfinal" else 8),
                           **f32)
        return lambda: ops.ssd_scan_bwd(x, dtA, b, b, states, x, dfin, chunk)
    return lambda: ops.ssd_scan(x, dtA, b, b, chunk)


@pytest.mark.parametrize("name", [
    "ring_write_capacity", "ring_write_fields", "ring_write_no_fields",
    "ring_write_batches", "ring_write_field_rows", "ring_write_batch_rows",
    "ring_write_row_shape", "per_topk_k", "per_topk_rows", "flash_heads",
    "flash_head_dim", "flash_prefix", "flash_batch", "flash_lse_shape",
    "flash_bwd_lse_shape", "flash_bwd_prefix", "flash_bwd_heads",
    "rmsnorm_bwd_weight", "decode_group", "decode_head_dim", "decode_empty_cache", "ssd_dims", "ssd_chunk",
    "ssd_initial_state", "ssd_bwd_ssd_dims", "ssd_bwd_ssd_chunk",
    "ssd_bwd_states", "ssd_bwd_dfinal",
    "ring_write_rowloop_capacity", "ring_gather_rowloop_rows",
    "per_scores_rows", "ring_gather_fields", "ring_gather_no_fields",
    "ring_gather_field_rows", "rope_head_dim", "rope_positions"])
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
        expect.update(rope=n_inv * 7, flash_attention=n_inv,
                      decode_attention=n_inv * 6)
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


NEW_FAMILIES = [("mixtral-8x7b", 80), ("kimi-k2-1t-a32b", 24),
                ("whisper-medium", 24), ("paligemma-3b", 24)]


@pytest.mark.parametrize("arch,P", NEW_FAMILIES)
def test_new_families_serving_on_the_card_matches_the_cpu(dev, arch, P):
    """Reduced MoE (mixtral's 64-slot window wrapped by an 80-token
    prompt; kimi's shared expert), enc-dec and VLM at float32 compute,
    the same parameters and prompts (frames, patches): prefill plus 6
    decode steps give the same tokens on the card as on the CPU, through
    the kernels. Launches a run (7 forwards): L + 1 + L norms a forward
    (none for whisper's LayerNorms), a flash attention a layer in the
    prefill (whisper: encoder, self and cross), one decode attention a
    layer a step (whisper: self and cross), and a rope before each
    attention but whisper's."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve.engine import greedy_generate, prefix_len
    cfg = get_config(arch).reduced()
    shape = InputShape("s", seq_len=P + prefix_len(cfg), global_batch=2,
                       kind="prefill")
    rc = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = factory.init_params(cfg, torch.Generator().manual_seed(0))
    batch = make_batch(cfg, shape, torch.Generator().manual_seed(1))
    want = greedy_generate(rc, params, batch, P, 6)
    rops.reset_launch_counts()
    got = greedy_generate(rc, tree_map(lambda a: a.to(dev), params),
                          tree_map(lambda a: a.to(dev), batch), P, 6)
    assert torch.equal(got.cpu(), want)
    L = cfg.num_layers
    if cfg.family == "encdec":
        expect = {"flash_attention": 3 * L, "decode_attention": 2 * L * 6}
    else:
        expect = {"rmsnorm": (2 * L + 1) * 7, "rope": L * 7,
                  "flash_attention": L, "decode_attention": L * 6}
    assert dict(rops.LAUNCH_COUNTS) == expect


def _chip_smoke():
    """``chip_smoke.py`` (at the repository's root) as a module: it
    imports no JAX."""
    import importlib
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("arch,seq,layers", [
    ("qwen2-0.5b", 16, 2), ("mixtral-8x7b", 16, 2),
    ("whisper-medium", 16, 2), ("paligemma-3b", 16, 2),
    ("mamba2-130m", 64, 2), ("zamba2-1.2b", 64, 3)])
def test_arch_rl_losses_on_the_card_match_the_cpu(dev, arch, seq, layers):
    """Both arch losses' gradients (``make_arch_spreeze_losses``, float32)
    on the card, through the kernels and their backward kernels, within
    chip_smoke's ``ARCH_RL_TOL`` of each leaf's largest value from the
    CPU's plain versions (the MoE with the CPU's routing replayed): the
    smoke's "arch RL checks" (``check_arch_rl_device_vs_cpu`` raises past
    the limit)."""
    cs = _chip_smoke()
    gaps = cs.check_arch_rl_device_vs_cpu(dev, arch, seq, layers)
    assert all(g["grad_rel"] <= cs.ARCH_RL_TOL for g in gaps.values())


def test_arch_update_launches_on_the_card(dev):
    """One ``make_arch_spreeze_update`` of reduced qwen2-0.5b towers on the
    card: finite losses, and exactly chip_smoke's
    ``arch_update_launches`` for its 2 layers."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core import model_parallel as mp
    from repro_torch.rl import networks as nets
    from repro_torch.train.optimizer import make_optimizer
    cs = _chip_smoke()
    cfg = get_config("qwen2-0.5b").reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    actor = nets.init_arch_policy(gen, cfg, 4)
    q = nets.init_arch_ensemble_q(gen, cfg, 4)
    q_target = tree_map(lambda a: a.clone(), q)
    for leaf in tree_leaves((actor, q)):
        leaf.requires_grad_()
    opt = make_optimizer("adam", 3e-4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           device=dev)
    act = torch.tanh(torch.randn((2, 4), generator=gen, device=dev))
    rew = torch.randn((2,), generator=gen, device=dev)
    done = torch.tensor([0.0, 1.0], device=dev)
    eps = torch.randn((2, 4), generator=gen, device=dev)
    rops.reset_launch_counts()
    cl, al = mp.make_arch_spreeze_update(cfg, opt, 4)(
        actor, q, q_target, opt.init(actor), opt.init(q), tokens, act, rew,
        done, eps)
    assert torch.isfinite(cl) and torch.isfinite(al)
    assert dict(rops.LAUNCH_COUNTS) == cs.arch_update_launches(
        cfg.num_layers)
