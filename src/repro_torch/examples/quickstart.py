"""Quickstart: 60 seconds of Spreeze SAC on Pendulum, via the public API.
Counterpart of ``examples/quickstart.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core import SpreezeConfig, SpreezeTrainer


def main(device="cuda", max_seconds=60.0):
    cfg = SpreezeConfig(
        env_name="pendulum",      # batched PyTorch env (vectorised samplers)
        algo="sac",               # sac | td3 | ddpg
        num_envs=8,               # "number of sampling processes"
        batch_size=2048,          # large-batch updates (paper §3.2.1)
        updates_per_round=8,
        transfer="shared",        # device-resident replay (paper §3.3.2)
        device=device,
    )
    trainer = SpreezeTrainer(cfg)
    hist = trainer.train(
        max_seconds=max_seconds, target_return=-200.0,
        log_cb=lambda t, r, f, u: print(
            f"t={t:6.1f}s  return={r:8.1f}  env_frames={f:>8}  updates={u}"))

    print(f"\nsampling rate   : {hist.sampling_hz:,.0f} Hz")
    print(f"update frequency: {hist.update_hz:,.1f} Hz")
    print(f"update framerate: {hist.update_frame_hz:,.0f} Hz")
    if hist.solved_time:
        print(f"solved (return >= -200) in {hist.solved_time:.1f}s")
    return hist


if __name__ == "__main__":
    main()
