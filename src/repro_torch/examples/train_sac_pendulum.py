"""End-to-end run: auto-adapted Spreeze SAC to solution, with the
paper's full pipeline: adaptation (§3.4), async sampler/updater (§3.1),
shared-memory replay (§3.3), SSD weight sync for eval, and a final
throughput report matching Table 2's columns. Counterpart of
``examples/train_sac_pendulum.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_sac_pendulum \\
          [--seconds 180] [--mesh 2x1 --placement ac]

``--mesh ACxBATCH`` needs AC x BATCH visible CUDA cards and raises with
fewer (it never falls back to fewer devices); with ``--device cpu`` the
mesh names the CPU AC x BATCH times.
"""
import argparse
import json
import sys

from repro_torch.core import SpreezeConfig, SpreezeTrainer, auto_tune


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--target", type=float, default=-200.0)
    ap.add_argument("--no-adapt", action="store_true")
    ap.add_argument(
        "--mesh", default=None, metavar="ACxBATCH",
        help="run the megastep over an (ac, batch) device mesh, e.g. "
             "'2x4': the double-Q ensemble lands on the ac axis (paper "
             "Fig. 2b dual-GPU split), replay rows split over batch. "
             "Needs ac*batch CUDA devices")
    ap.add_argument(
        "--placement", default="ac", choices=("ac", "dp"),
        help="mesh placement: 'ac' = actor/critic model parallelism "
             "(Fig. 2b), 'dp' = data-parallel baseline (Fig. 2a, "
             "gradients summed over every group)")
    ap.add_argument(
        "--overlap-eval", action="store_true",
        help="the megastep copies the actor at its end for eval/viz, "
             "which then never wait for the next megastep")
    ap.add_argument(
        "--inline-eval", action="store_true",
        help="run eval/viz inline on the train thread instead of on the "
             "async host runtime's background workers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_ac_mesh, parse_ac_spec
        ac, batch = parse_ac_spec(args.mesh)
        # the CPU is named once a group; a card mesh takes the visible
        # CUDA devices and raises when there are too few
        mesh = make_ac_mesh(ac, batch, ["cpu"] * (ac * batch)
                            if args.device == "cpu" else None)

    if args.no_adapt:
        batch_size, num_envs = 2048, 8
        rpd = SpreezeConfig.rounds_per_dispatch
    else:
        print("== hyperparameter adaptation (paper §3.4) ==")
        tuned = auto_tune(args.env, "sac",
                          bs_grid=(128, 512, 2048, 8192),
                          env_grid=(2, 4, 8, 16, 32),
                          rpd_grid=(1, 2, 4, 8), iters=2,
                          device=args.device, mesh=mesh,
                          placement=args.placement)
        batch_size, num_envs = tuned["batch_size"], tuned["num_envs"]
        rpd = tuned["rounds_per_dispatch"]
        for c in tuned["bs_log"].candidates:
            print(f"  batch {c['value']:>6}: {c['throughput']:,.0f} "
                  "update-frames/s")
        for c in tuned["env_log"].candidates:
            print(f"  envs  {c['value']:>6}: {c['throughput']:,.0f} "
                  "env-frames/s")
        for c in tuned["rpd_log"].candidates:
            print(f"  r/dis {c['value']:>6}: {c['throughput']:,.0f} "
                  "rounds/s")
        print(f"  -> batch_size={batch_size} num_envs={num_envs} "
              f"rounds_per_dispatch={rpd}\n")

    cfg = SpreezeConfig(
        env_name=args.env, algo="sac", num_envs=num_envs,
        batch_size=batch_size, updates_per_round=8,
        rounds_per_dispatch=rpd,
        mesh=mesh, placement=args.placement,
        overlap_eval=args.overlap_eval,
        weight_sync="ssd",          # eval reads .npz snapshots (paper §3.3.1)
        async_eval=(False if args.inline_eval else None),
        eval_every_rounds=25, device=args.device)
    trainer = SpreezeTrainer(cfg)
    print("== training ==")
    hist = trainer.train(
        max_seconds=args.seconds, target_return=args.target,
        log_cb=lambda t, r, f, u: print(
            f"t={t:6.1f}s  return={r:8.1f}  frames={f:>8}  updates={u}"))

    print("\n== Table-2-style report ==")
    print(json.dumps({
        "sampling_frame_rate_hz": round(hist.sampling_hz),
        "update_frequency_hz": round(hist.update_hz, 1),
        "update_frame_rate_hz": round(hist.update_frame_hz),
        "experience_transfer_cycle_s":
            hist.transfer_stats["transfer_cycle_s"],
        "transmission_loss": hist.transfer_stats["transmission_loss"],
        "solved_time_s": hist.solved_time,
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
