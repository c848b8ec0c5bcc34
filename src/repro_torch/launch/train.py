"""Training launcher: the ``rl`` mode of ``repro/launch/train.py``.

Spreeze SAC, TD3 or DDPG on a batched PyTorch env: ``SpreezeTrainer``'s
fused megastep over the device-resident replay ring, or with
``--transfer queue`` or ``--sync`` the eager per-round loop of the
paper's Fig. 4a ablations. ``--weight-sync ssd`` sends the weights to
the async eval workers through ``.npz`` files (the paper's SSD channel).
Runs on the CUDA card unless ``--device cpu`` is given; the device
decides between the hand-written kernels and their plain versions.
Prints the card line and then the reference's JSON report
(``sampling_hz``, ``update_hz``, ``update_frame_hz``, ``solved_time_s``,
``final_return``, ``transfer``).

Examples:
  python -m repro_torch.launch.train rl --env pendulum --algo sac --seconds 120
  python -m repro_torch.launch.train rl --algo td3 --seconds 30
  python -m repro_torch.launch.train rl --transfer queue --queue-size 5000 \\
      --sync --seconds 30
  python -m repro_torch.launch.train rl --algo ddpg --device cpu \\
      --seconds 2 --num-envs 2 --batch-size 64

Not ported yet: the reference's ``--adapt`` (auto-tune) and the ``lm``
mode; argparse refuses them, as it refuses ``--prioritized``, which the
reference's launcher does not have either.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    rl = sub.add_parser("rl")
    rl.add_argument("--env", default="pendulum")
    rl.add_argument("--algo", default="sac", choices=("sac", "td3", "ddpg"))
    rl.add_argument("--seconds", type=float, default=60.0)
    rl.add_argument("--target-return", type=float, default=None)
    rl.add_argument("--num-envs", type=int, default=16)
    rl.add_argument("--batch-size", type=int, default=8192)
    rl.add_argument("--updates-per-round", type=int, default=4)
    rl.add_argument("--transfer", default="shared",
                    choices=("shared", "queue"))
    rl.add_argument("--queue-size", type=int, default=20000)
    rl.add_argument("--sync", action="store_true",
                    help="partial-parallel baseline (paper Fig. 4a)")
    rl.add_argument("--weight-sync", default="live",
                    choices=("live", "ssd"))
    rl.add_argument("--seed", type=int, default=0)
    rl.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import card_line
    from repro_torch.core import SpreezeConfig, SpreezeTrainer

    cfg = SpreezeConfig(env_name=args.env, algo=args.algo,
                        num_envs=args.num_envs, batch_size=args.batch_size,
                        updates_per_round=args.updates_per_round,
                        transfer=args.transfer, queue_size=args.queue_size,
                        sync_mode=args.sync, weight_sync=args.weight_sync,
                        seed=args.seed, device=args.device)
    trainer = SpreezeTrainer(cfg)
    hist = trainer.train(
        max_seconds=args.seconds, target_return=args.target_return,
        log_cb=lambda t, r, f, u: print(
            f"  t={t:7.1f}s return={r:9.2f} frames={f} updates={u}",
            flush=True))
    print(card_line(trainer.device))
    print(json.dumps({
        "sampling_hz": round(hist.sampling_hz, 1),
        "update_hz": round(hist.update_hz, 2),
        "update_frame_hz": round(hist.update_frame_hz, 1),
        "solved_time_s": hist.solved_time,
        "final_return": hist.eval_returns[-1] if hist.eval_returns
        else None,
        "transfer": hist.transfer_stats,
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
