"""Auto-tune in the port (``core/adaptation.py``): the adaptation cases of
``tests/test_pipeline.py`` on the CPU, and the grid walk held against the
reference's on the same throughput curves."""
import pytest
import torch

from repro.core import adaptation as jax_adaptation
from repro_torch.core import adaptation
from repro_torch.replay import buffer as rb

torch.set_num_threads(2)

# throughput by candidate: rising then flat, rising throughout, flat at
# once, a dip and a recovery the walk never sees, gains just under and
# just over the 10% threshold
CURVES = {
    "flattens": {1: 100.0, 2: 200.0, 4: 210.0, 8: 400.0},
    "rises": {1: 1.0, 2: 2.0, 4: 4.0, 8: 8.0},
    "flat": {1: 5.0, 2: 5.0, 4: 5.0, 8: 5.0},
    "dip": {1: 10.0, 2: 30.0, 4: 3.0, 8: 300.0},
    "edge": {1: 100.0, 2: 109.99, 4: 121.0, 8: 133.1},
    "over": {1: 100.0, 2: 110.01, 4: 121.1, 8: 133.0},
}


@pytest.mark.parametrize("curve", list(CURVES))
def test_tune_geometric_probes_and_picks_as_the_reference(curve):
    got_calls, want_calls = [], []

    def measure(calls):
        def m(v):
            calls.append(v)
            return CURVES[curve][v]
        return m

    grid = (1, 2, 4, 8)
    best, log = adaptation.tune_geometric(measure(got_calls), grid)
    want, jlog = jax_adaptation.tune_geometric(measure(want_calls), grid)
    assert (best, got_calls) == (want, want_calls)
    assert log.candidates == jlog.candidates and log.chosen == jlog.chosen


def test_tune_geometric_stops_on_flat_curve():
    best, log = adaptation.tune_geometric(CURVES["flattens"].__getitem__,
                                          (1, 2, 4, 8), min_gain=0.10)
    # 4 gives under 10% over 2: stop; 8 is never probed (convexity)
    assert best == 2
    assert [c["value"] for c in log.candidates] == [1, 2, 4]


def test_time_fn_runs_warmup_then_iters():
    calls = []
    sec = adaptation._time_fn(lambda: calls.append(1), iters=3, warmup=2,
                              device="cpu")
    assert len(calls) == 5 and sec >= 0.0


def test_auto_tune_picks_from_tiny_grids():
    tuned = adaptation.auto_tune("pendulum", "sac", bs_grid=(32, 64),
                                 env_grid=(1, 2), rpd_grid=(1, 2), iters=1,
                                 device="cpu")
    assert tuned["batch_size"] in (32, 64)
    assert tuned["num_envs"] in (1, 2)
    assert tuned["rounds_per_dispatch"] in (1, 2)
    for k in ("bs_log", "env_log", "rpd_log"):
        assert len(tuned[k].candidates) >= 1
        assert all(c["throughput"] > 0 for c in tuned[k].candidates)


def test_probe_replay_matches_the_trained_batch():
    """The timed update probe samples the field set and value domains
    training uses: a "disc" row and {0, 1} dones."""
    gen = torch.Generator().manual_seed(0)
    rep = adaptation.probe_replay(3, 1, 64, 0.99, gen, "cpu")
    assert "disc" in rep.data
    done = rep.data["done"]
    assert set(torch.unique(done).tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(rep.data["disc"], 0.99 * (1.0 - done),
                               rtol=1e-6, atol=0)
    assert int(rep.size) == 64
    idx = rb.uniform_indices(rep, 16, gen)
    batch = rb.sample(rep, idx)
    assert set(batch) == set(rb.trainer_specs(3, 1))
