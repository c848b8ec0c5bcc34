"""``rope_calls.lm``: the rotary kernel's forward and backward launches an
arch update, from a snapshot built here; None where no rope kernel
launched (the CPU's plain version, a program without the kernel) or no
update was counted."""
import pytest

from bench.lib import harness, program_trace

EMPTY = {"spans": {}, "first": {}, "first_self": {}, "counters": {},
         "launches": {}, "dropped": 0}


@pytest.mark.parametrize("launches, counters, want", [
    ({"rope": 352 * 3, "rope_bwd": 96 * 3, "rmsnorm": 7},
     {"arch.updates": 3}, 448.0),
    ({"rope": 10}, {"arch.updates": 4}, 2.5),
    ({"rmsnorm": 7}, {"arch.updates": 3}, None),
    ({"rope": 10}, {}, None),
])
def test_reader_on_a_built_snapshot(launches, counters, want, monkeypatch):
    read = harness.load_metric("rope_calls.lm")
    snap = {**EMPTY, "launches": launches, "counters": counters}
    monkeypatch.setattr(program_trace, "snapshot", lambda: snap)
    ctx = harness.Context(cell={}, config={}, traffic={}, setup_s=1.0,
                          window={})
    assert read(ctx) == want
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    assert read(ctx) is None
