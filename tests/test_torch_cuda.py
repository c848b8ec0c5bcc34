"""The port's CUDA kernels and trainer on the card. Every test here needs
a CUDA device and skips without one (marker ``gpu``); this module imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import replay_ops as rops

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


def _pool(dev, rows, live, seed, ties=()):
    """Priorities with ``live`` written rows (a tenth of them zeroed) and
    a Gumbel field; rows in ``ties`` share one priority and one Gumbel
    value among the best scores."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pri = torch.zeros(rows, device=dev)
    pri[:live] = torch.rand(live, generator=g, device=dev) * 5 + 1e-3
    pri[torch.rand(rows, generator=g, device=dev) < 0.1] = 0.0
    u = torch.rand(rows, generator=g, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    if ties:
        t = torch.tensor(ties, device=dev)
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
])
def test_per_topk_kernel_matches_plain(dev, rows, k, live, lo, ties):
    pri, gumbel = _pool(dev, rows, live, rows + k, ties)
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.per_topk(pri, gumbel, 0.6, k, **kw)
    want = rops.per_topk_ref(pri, gumbel, 0.6, k, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    if ties:
        assert got[1][:len(ties)].tolist() == [i + (lo or 0) for i in ties]
    assert rops.LAUNCH_COUNTS["per_topk"] == 1


@pytest.mark.parametrize("rows,lo", [(48, None), (48, 16),
                                     (262_144, None)])
def test_priority_scatter_kernel_matches_plain(dev, rows, lo):
    """Repeated indices (the last write wins) and out-of-window ones."""
    g = torch.Generator(device=dev).manual_seed(rows)
    base = lo or 0
    pri = torch.rand(rows, generator=g, device=dev)
    idx = torch.cat([
        torch.randint(base, base + rows, (8192,), generator=g, device=dev),
        torch.tensor([base - 1, base + rows, -1, base + 3, base + 3],
                     device=dev)]).to(torch.int32)
    vals = torch.rand(idx.shape[0], generator=g, device=dev) * 9
    kw = {} if lo is None else {
        "window_start": torch.tensor(lo, dtype=torch.int32, device=dev)}
    got = rops.priority_scatter(pri.clone(), idx, vals, **kw)
    want = rops.priority_scatter_ref(pri.clone(), idx, vals, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[3]) == float(vals[-1])
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
    assert dict(rops.LAUNCH_COUNTS) == {"ring_write": 6 * 2,
                                        "ring_gather": 6 * 2 * 2}
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert int(tr.replay.ptr) == (64 + 64) % 100


def test_per_megastep_on_the_card_goes_through_the_kernels(dev):
    """Per round 7 ring writes (6 fields + priorities); per update 7
    gathers (6 fields + the priority mass), one top-k, one scatter."""
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
    assert dict(rops.LAUNCH_COUNTS) == {"ring_write": 7 * 2,
                                        "ring_gather": 7 * 2 * 2,
                                        "per_topk": 2 * 2,
                                        "priority_scatter": 2 * 2}
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert bool((tr.replay.priorities > 0).all())
    assert float(tr.replay.max_priority) >= 1.0
