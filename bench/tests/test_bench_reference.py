"""Each plain reference against the port's own CPU path at a tiny size,
through the harness's whole run but its look for a card: sound runs come
out ``correct``, and with the timed path broken underneath (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest) they do not. The bf16 towers' float8 control is caught
here; the float32 megastep's TF32 control needs the card (``gpu``)."""
import json
import os

import pytest
import torch

from bench import calibrate
from bench.lib import harness
from bench.lib.faults import FAULTS

LM = {"config": {"num_hidden_layers": 2, "hidden_size": 64,
                 "intermediate_size": 128, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "head_dim": 16,
                 "vocab_size": 256},
      "traffic": {"batch": 4, "seq": 32, "ref_rows": 2,
                  "distinct_batches": 4, "trace_updates": 1}}
SAC = {"config": {"replay_capacity": 1024, "hidden": [32, 32]},
       "traffic": {"batch_size": 64, "warmup_frames": 256, "num_envs": 4,
                   "chunk_len": 8, "updates_per_round": 2,
                   "rounds_per_dispatch": 2, "trace_megasteps": 1}}
SEED = 2 ** 31 + 12345


def with_pending():
    """The benchmark with the pending SAC cells added."""
    bm = harness.load_benchmark()
    with open(os.path.join(harness.BENCH_DIR, "pending",
                           "sac-pendulum.json")) as f:
        pending = json.load(f)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        bm[k] = bm[k] + pending[k]
    return bm


CELLS = [("smollm-360m-rl.b32x1024", LM), ("smollm-360m-rl.b16x2048", LM),
         ("sac-pendulum.bs32768", SAC), ("sac-pendulum.per-bs32768", SAC)]


@pytest.mark.parametrize("cell,sizes", CELLS)
def test_sound_run_is_correct(cell, sizes):
    out = harness.run(cell, SEED, 0.2, True, device="cpu", overrides=sizes,
                      bm=with_pending())
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell,sizes", CELLS[1:3])
def test_broken_timed_path_is_not_correct(cell, sizes, fault):
    with FAULTS[fault]():
        out = harness.run(cell, SEED, 0.2, False, device="cpu",
                          overrides=sizes, bm=with_pending())
    assert not out["correct"], out["check"]


def test_float8_control_of_the_bf16_towers_is_caught():
    cell = "smollm-360m-rl.b32x1024"
    row, = calibrate.readings(cell, [3], True, [], device="cpu",
                              overrides=LM)
    limits = harness.cell_parts(cell)[3]["limits"]
    assert all(row["sound"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items())


@pytest.mark.gpu
def test_tf32_control_of_the_megastep_is_caught():
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control computes differently only on the card")
    cell = "sac-pendulum.bs32768"
    bm = with_pending()
    row, = calibrate.readings(cell, [3], True, [], device="cuda",
                              overrides=SAC, bm=bm)
    limits = harness.cell_parts(cell, bm=bm)[3]["limits"]
    assert all(row["sound"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items())
