"""The port's training launcher (the ``rl`` mode of
``repro/launch/train.py``) on the CPU with tiny flags."""
import json

import pytest
import torch

from repro_torch.launch import train

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--seconds", "0.3", "--num-envs", "2",
        "--batch-size", "16", "--updates-per-round", "1"]


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_rl_launcher_prints_the_reference_report(algo, capsys):
    assert train.main(["rl", "--algo", algo] + TINY) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert set(report) == {"sampling_hz", "update_hz", "update_frame_hz",
                           "solved_time_s", "final_return", "transfer"}
    assert report["sampling_hz"] > 0 and report["update_hz"] > 0
    assert report["update_frame_hz"] > 0
    assert report["final_return"] < 0          # pendulum: costs only
    assert "device: cpu" in out


@pytest.mark.parametrize("flags,field,value", [
    (["--transfer", "queue"], "transfer", "queue"),
    (["--queue-size", "10"], "queue_size", 10),
    (["--sync"], "sync_mode", True),
    (["--weight-sync", "ssd"], "weight_sync", "ssd")])
def test_ported_flags_reach_the_config(monkeypatch, capsys, flags, field,
                                       value):
    """``--transfer``, ``--queue-size``, ``--sync`` and ``--weight-sync``
    set the reference's ``SpreezeConfig`` fields, and the run reports."""
    from repro_torch import core
    seen = []

    class Recording(core.SpreezeTrainer):
        def __init__(self, cfg, *a, **kw):
            seen.append(cfg)
            super().__init__(cfg, *a, **kw)

    monkeypatch.setattr(core, "SpreezeTrainer", Recording)
    assert train.main(["rl"] + flags + TINY) == 0
    assert len(seen) == 1 and getattr(seen[0], field) == value
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["update_hz"] > 0
    assert set(report["transfer"]) == {"transfer_cycle_s",
                                       "transmission_loss", "blocked_time_s"}


@pytest.mark.parametrize("flags", [
    ["--adapt"], ["--prioritized"], ["--algo", "ppo"]])
def test_unported_flags_are_refused(flags):
    with pytest.raises(SystemExit) as e:
        train.main(["rl"] + flags + TINY)
    assert e.value.code == 2


def test_lm_mode_is_refused():
    with pytest.raises(SystemExit) as e:
        train.main(["lm", "--arch", "qwen2-0.5b"])
    assert e.value.code == 2


def test_launcher_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["rl", "--algo", "td3", "--seconds", "0.1"])
