"""The granite-4.0-h-micro cell through the harness's whole run but its
look for a card, at a tiny size on the CPU (the program's plain
versions of its kernels): a sound run is ``correct`` and reads the
model-layer numbers its runner adds; with either fault of
``bench/lib/faults.py`` underneath the timed path it is not; and the
float8 control fails ``outputs``. The runner's traced reduction links
each kernel to its launching op alone, not to CUPTI's bookkeeping events
as well, and only for the run that asked for it."""
from types import SimpleNamespace

import pytest
import torch

from bench import calibrate
from bench.lib import harness
from bench.lib import trace as trace_lib
from bench.lib.faults import FAULTS
from bench.runners import arch_rl_update_hybrid as hybrid

CELL = "granite-4.0-h-micro-rl.b32x1024"
HYBRID = {"config": {"hidden_size": 64, "intermediate_size": 128,
                     "num_attention_heads": 4, "num_key_value_heads": 2,
                     "vocab_size": 256, "mamba_d_state": 16,
                     "mamba_d_head": 16, "mamba_chunk_size": 16},
          "traffic": {"batch": 4, "seq": 32, "ref_rows": 2,
                      "distinct_batches": 4, "trace_updates": 1}}
SEED = 2 ** 31 + 12345
REDUCE = trace_lib.reduce_events


def _event(name, start, end, kernels=(), device=False):
    kind = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        kernels=list(kernels), is_user_annotation=False,
        device_type=kind.CUDA if device else kind.CPU)


@pytest.mark.parametrize("blocked", ["Command Buffer Full",
                                     "Activity Buffer Request",
                                     "Buffer Flush"])
def test_a_kernel_is_linked_to_its_op_alone(blocked):
    """A launch that blocked: CUPTI links its kernel (5 us) to the op
    that launched it and to the bookkeeping event. The plain reduction
    gives the span both links; the runner's gives it the op's, and puts
    the plain reduction back once it has run."""
    k = SimpleNamespace(duration=5.0)
    events = [_event(trace_lib.PREFIX + "ssm_mixer", 0.0, 100.0),
              _event("aten::mul", 10.0, 12.0, [k]),
              _event(blocked, 11.0, 30.0, [k]),
              _event("elementwise_kernel", 40.0, 45.0, device=True)]
    plain = REDUCE(events, 1e-4, {})
    assert plain.span("ssm_mixer").device_ops == 2
    trace_lib.reduce_events = hybrid._op_linked(REDUCE)
    try:
        got = trace_lib.reduce_events(events, 1e-4, {})
        assert trace_lib.reduce_events is REDUCE
    finally:
        trace_lib.reduce_events = REDUCE
    assert got.span("ssm_mixer").device_ops == 1 == got.device_ops
    assert got.span("ssm_mixer").device_s == 5e-6 == got.busy_s


def test_sound_run_is_correct():
    out = harness.run(CELL, SEED, 0.2, True, device="cpu",
                      overrides=HYBRID)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = out["metrics"]
    assert m["ssm_mixers.hybrid"]["value"] == 99.0
    assert m["backbone_forwards.lm"]["value"] == 8.0
    assert m["mfu.lm"]["value"] > 0
    assert list(out)[-1] == "check"
    assert trace_lib.reduce_events is REDUCE     # the patch went with it


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    with FAULTS[fault]():
        out = harness.run(CELL, SEED, 0.2, False, device="cpu",
                          overrides=HYBRID)
    assert not out["correct"], out["check"]


def test_float8_control_fails_outputs():
    row, = calibrate.readings(CELL, [3], True, [], device="cpu",
                              overrides=HYBRID)
    limits = harness.cell_parts(CELL)[3]["limits"]
    assert all(row["sound"][k] <= v for k, v in limits.items())
    assert row["control"]["outputs"] > limits["outputs"]
