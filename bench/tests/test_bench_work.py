"""The benchmark's frozen yardstick (``bench/work``) against the program's
own arithmetic today, and the readers' arithmetic on known shapes."""
import pytest
import torch

from bench.lib import readers
from bench.lib.harness import Context
from bench.lib.trace import SpanStats, Trace
from bench.work import kernel_work, model_flops, peaks

BF16, F32 = torch.bfloat16, torch.float32


def _port():
    from repro_torch.kernels import work
    from repro_torch.launch import analysis
    return work, analysis


CALLS = [
    ("ring_write", (256, 40)), ("ring_gather", (32768, 40)),
    ("ring_gather", (32768, 40, 29000)), ("per_scores", (262144,)),
    ("per_topk", (262144, 32768)), ("priority_scatter", (32768, 30000)),
    ("rmsnorm", (32768, 960, BF16)), ("rmsnorm_bwd", (32768, 960, BF16)),
    ("rmsnorm", (8, 64, F32)),
    ("flash_attention", (32, 1024, 1024, 15, 5, 64, BF16)),
    ("flash_attention_bwd", (16, 2048, 2048, 15, 5, 64, BF16)),
    ("decode_attention", (8, 1088, 14, 2, 64, BF16)),
    ("ssd_scan", (8, 1024, 24, 64, 128, 256, BF16)),
    ("ssd_scan_bwd", (8, 1024, 24, 64, 128, 256, BF16)),
]


@pytest.mark.parametrize("name,args", CALLS)
def test_kernel_work_matches_the_program(name, args):
    work, _ = _port()
    mine, theirs = getattr(kernel_work, name)(*args), getattr(work, name)(*args)
    assert (mine.bytes, mine.flops, mine.flop_type, mine.launches) == (
        theirs.bytes, theirs.flops, theirs.flop_type, theirs.launches)


def test_flash_lse_and_masks_match_the_program():
    work, _ = _port()
    for kw in ({"lse": True}, {"causal": False}, {"window": 64},
               {"prefix_len": 16}):
        a = kernel_work.flash_attention(2, 128, 128, 4, 2, 64, BF16, **kw)
        b = work.flash_attention(2, 128, 128, 4, 2, 64, BF16, **kw)
        assert (a.bytes, a.flops) == (b.bytes, b.flops)


@pytest.mark.parametrize("B,S", [(32, 1024), (16, 2048), (2, 64)])
def test_backbone_flops_and_peaks_match_the_program(B, S):
    _, analysis = _port()
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m")
    mine = model_flops.backbone_flops(cfg.num_layers, cfg.d_model,
                                      cfg.num_heads, cfg.num_kv_heads,
                                      cfg.head_dim, cfg.d_ff, B, S)
    assert mine == analysis.backbone_flops(cfg, B, S)
    assert (peaks.PEAK_FLOPS_BF16, peaks.PEAK_FLOPS_F32, peaks.HBM_BW) == (
        analysis.PEAK_FLOPS_BF16, analysis.PEAK_FLOPS_F32, analysis.HBM_BW)
    w = kernel_work.flash_attention(B, S, S, 15, 5, 64, BF16)
    assert peaks.bound_s(w)[0] * 1e3 == pytest.approx(
        analysis.bound_ms(w)[0])


def test_sac_update_flops():
    actor, critic = [3, 256, 256, 2], [4, 256, 256, 1]
    f = 2 * (3 * 256 + 256 * 256 + 256 * 2)
    assert model_flops.mlp_forward_flops(actor) == f
    assert model_flops.mlp_forward_flops(critic) == f
    # critic loss 5 forwards + 2 backwards (2 each), actor loss 3 forwards,
    # the critics' backward to the action (1 each) and the actor's (2)
    assert model_flops.sac_update_flops_per_sample(actor, critic) == 16 * f


def _trace(**kw):
    base = dict(window_s=2.0, busy_s=0.5, device_ops=100, op_seconds={},
                spans={}, calls={}, top_ops=[], idle_gaps=[])
    base.update(kw)
    return Trace(**base)


def _ctx(trace=None, traced=None, window=None):
    return Context(cell={}, config={}, traffic={}, setup_s=1.0,
                   window=window or {}, trace=trace, traced=traced or {})


def test_readers_on_known_numbers():
    w = kernel_work.rmsnorm(32768, 960, BF16)     # bytes bound: 37.7 us
    t = _trace(spans={"op.rmsnorm": SpanStats(count=2, device_s=1e-4),
                      "update_round": SpanStats(count=4, device_s=0.02,
                                                device_ops=800)},
               calls={"rmsnorm": [w, w]},
               op_seconds={"nvjet_tst_x": 0.3, "sm90_xmma_gemm_y": 0.1,
                           "flash_tc_kernel": 0.2})
    ctx = _ctx(t, {"updates": 8, "rounds": 2},
               {"model_flops": 67e12, "wall_s": 2.0, "updates": 4})
    # 0.5 s busy over 8 traced updates against 0.5 s an update untraced
    assert readers.idle_share(ctx) == pytest.approx(87.5)
    assert readers.mfu(ctx, peaks.PEAK_FLOPS_F32) == pytest.approx(50.0)
    assert readers.span_ms(ctx, ["update_round"], "updates") == \
        pytest.approx(2.5)
    assert readers.roofline(ctx, "rmsnorm") == pytest.approx(
        100 * 2 * w.bytes / peaks.HBM_BW / 1e-4)
    assert readers.gemm_ms(ctx, "updates") == pytest.approx(50.0)


def test_readers_read_nothing_without_the_trace():
    ctx = _ctx()
    assert readers.idle_share(ctx) is None
    assert readers.roofline(ctx, "rmsnorm") is None
    assert readers.span_ms(ctx, ["update_round"], "updates") is None
    t = _trace(spans={"op.rmsnorm": SpanStats(count=1, device_s=0.0)},
               calls={"rmsnorm": [kernel_work.rmsnorm(8, 64, F32)]})
    assert readers.roofline(_ctx(t, {"updates": 1}), "rmsnorm") is None
    assert readers.mfu(_ctx(window={"wall_s": 1.0}), 1e12) is None
