"""The port's mesh (``launch/mesh.py``, ``distributed/sharding.py``): the
ring shards each placement makes, the refusals of too few devices, a bad
spec and an unknown placement, against the reference's messages; and the
two examples (``repro_torch.examples``), run briefly on the CPU."""
import contextlib
import io
import json

import pytest
import torch

from repro_torch.distributed.sharding import (Mesh, batch_axes,
                                              group_devices, trainer_rules)
from repro_torch.examples import quickstart, train_sac_pendulum
from repro_torch.launch import mesh as lmesh

torch.set_num_threads(2)

SHAPES = [(1, 1), (2, 1), (2, 2), (2, 4)]


@pytest.mark.parametrize("placement", ["ac", "dp"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_ring_shard_groups(shape, placement):
    """Under ac the ring splits over the batch axis only; under dp over
    every device, row-major."""
    ac, batch = shape
    devs = [torch.device("cuda", i) for i in range(ac * batch)]
    mesh = lmesh.make_ac_mesh(ac, batch, devices=devs)
    want = batch if placement == "ac" else ac * batch
    assert lmesh.ring_shard_groups(mesh, placement) == want
    rules = trainer_rules(mesh, placement)
    assert batch_axes(rules) == (("batch",) if placement == "ac"
                                 else ("ac", "batch"))
    assert group_devices(rules) == devs[:want]
    assert mesh.primary == devs[0] and mesh.shape == {"ac": ac,
                                                      "batch": batch}


def test_make_ac_mesh_raises_with_too_few_cuda_devices():
    """No fallback: a mesh that names more cards than are visible raises
    with the counts (here, where no card is visible, any mesh)."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"need {have + 1} devices for an "
                       f"{have + 1}x1 ac mesh, found {have}"):
        lmesh.make_ac_mesh(have + 1, 1)


def test_make_ac_mesh_may_name_a_device_more_than_once():
    mesh = lmesh.make_ac_mesh(2, 0, devices=["cpu"] * 6)
    assert isinstance(mesh, Mesh) and mesh.shape == {"ac": 2, "batch": 3}
    assert mesh.distinct_devices == [torch.device("cpu")]


@pytest.mark.parametrize("spec", ["2", "ax4", "2x4x1", ""])
def test_parse_ac_mesh_refuses_a_bad_spec(spec):
    with pytest.raises(ValueError, match="want 'ACxBATCH', e.g. '2x4'"):
        lmesh.parse_ac_mesh(spec, devices=["cpu"] * 8)


def test_parse_ac_mesh_builds_the_named_mesh():
    mesh = lmesh.parse_ac_mesh("2X2", devices=["cpu"] * 4)
    assert mesh.shape == {"ac": 2, "batch": 2}


def test_trainer_rules_refuse_an_unknown_placement():
    mesh = lmesh.make_ac_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="unknown placement 'tp'"):
        trainer_rules(mesh, "tp")


def _stdout(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def test_quickstart_runs_briefly_on_the_cpu():
    hist, text = _stdout(quickstart.main, device="cpu", max_seconds=0.2)
    assert hist.update_hz > 0
    assert "update frequency" in text and "sampling rate" in text


@pytest.mark.parametrize("extra", [[], ["--mesh", "2x2"],
                                   ["--mesh", "2x2", "--placement", "dp",
                                    "--inline-eval", "--overlap-eval"]],
                         ids=["one-device", "ac-2x2", "dp-2x2-inline"])
def test_train_sac_pendulum_runs_briefly_on_the_cpu(extra):
    rc, text = _stdout(train_sac_pendulum.main,
                       ["--seconds", "0.2", "--no-adapt", "--device", "cpu"]
                       + extra)
    report = json.loads(text[text.index("{"):])
    assert rc == 0 and report["update_frequency_hz"] > 0
    assert set(report) == {"sampling_frame_rate_hz", "update_frequency_hz",
                           "update_frame_rate_hz",
                           "experience_transfer_cycle_s",
                           "transmission_loss", "solved_time_s"}


def test_train_sac_pendulum_refuses_a_mesh_of_missing_cards():
    """``--mesh`` on the card names that many visible CUDA devices: with
    too few it raises ``make_ac_mesh``'s message, never running on
    fewer."""
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"found {have}"):
        train_sac_pendulum.main(["--seconds", "0.2", "--no-adapt",
                                 "--mesh", f"{have + 1}x1"])
