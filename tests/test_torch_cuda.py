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


@pytest.mark.parametrize("B,S,H,KV,d,vl", [
    (2, 128, 4, 2, 32, 128),
    (1, 100, 3, 1, 16, 77),          # partial cache, odd length
    (8, 1088, 14, 2, 64, 1030),      # the serving shape, several splits
    (1, 64, 2, 2, 8, 1),             # first decode step
    (1, 96, 15, 5, 32, 50),
    (2, 600, 16, 1, 128, 600),       # the largest group and head_dim
    (1, 100, 4, 2, 64, 150),         # valid_len past S is clamped
    (1, 300, 4, 2, 64, 0),           # nothing valid: zeros, no NaN
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
        return lambda: ops.ring_write(d, torch.ones((5, 3), **f32),
                                      torch.zeros(1, **i32), None, 4)
    if name in ("per_topk_k", "per_topk_scratch"):
        k = 9 if name == "per_topk_k" else 4
        pri = torch.ones(8, **f32)
        return lambda: ops.per_topk(
            pri, pri, None, torch.zeros(1, device=dev, dtype=torch.int64),
            torch.empty(k, **f32), torch.empty(k, **i32), 0.6, k)
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
                                torch.empty_like(x), x.new_empty((1, 2, P, 8)),
                                chunk)


@pytest.mark.parametrize("name", [
    "ring_write_capacity", "per_topk_k", "per_topk_scratch", "flash_heads",
    "flash_head_dim", "decode_group", "decode_empty_cache", "ssd_dims",
    "ssd_chunk"])
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
