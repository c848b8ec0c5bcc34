"""The readers of the program's own spans and counters
(``bench/lib/program_trace.py``; ``kernel_load_s``, ``first_update_s.lm``,
``backbone_forwards.lm``): each number from a snapshot built here, None
from an empty one and from a program without ``repro_torch.trace``, and
8 tower forwards an update from a run of the reduced update through the
real module."""
import pytest

from bench.lib import harness, program_trace
from bench.tests.test_bench_reference import LM, SEED

SNAP = {"spans": {}, "first": {"kernels.load": 1.25, "arch.update": 4.0},
        "first_self": {"kernels.load": 1.25, "arch.update": 2.75},
        "counters": {"arch.updates": 6, "model.backbone_forwards": 48},
        "launches": {}, "dropped": 0}
READ = {"kernel_load_s": 1.25, "first_update_s.lm": 2.75,
        "backbone_forwards.lm": 8.0}


def _ctx():
    return harness.Context(cell={}, config={}, traffic={}, setup_s=1.0,
                           window={})


@pytest.mark.parametrize("name", sorted(READ))
def test_reader_on_a_built_snapshot(name, monkeypatch):
    read = harness.load_metric(name)
    monkeypatch.setattr(program_trace, "snapshot", lambda: SNAP)
    assert read(_ctx()) == pytest.approx(READ[name])
    empty = {"spans": {}, "first": {}, "first_self": {}, "counters": {},
             "launches": {}, "dropped": 0}
    monkeypatch.setattr(program_trace, "snapshot", lambda: empty)
    assert read(_ctx()) is None
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    assert read(_ctx()) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import sys

    import repro_torch
    import repro_torch.trace  # noqa: F401
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert program_trace.snapshot() is None


def test_the_reduced_update_runs_eight_forwards():
    from repro_torch import trace
    trace.reset()
    out = harness.run("smollm-360m-rl.b32x1024", SEED, 0.2, True,
                      device="cpu", overrides=LM)
    assert out["correct"]
    assert out["metrics"]["backbone_forwards.lm"]["value"] == 8.0
    assert out["metrics"]["first_update_s.lm"]["value"] > 0
    assert "kernel_load_s" not in out["metrics"]    # no kernels on the CPU
