"""Preemption-safe resume: snapshot bundles of the whole trainer state.
Counterpart of ``repro/train/resume.py``.

A bundle holds everything the next megastep reads: the ``AlgoState``
(actor, Q and target parameters, optimizer moments, alpha, step), the
replay ring with its cursor (and the PER priorities and max priority
when prioritized), the env states, and the draw source's state
(``draws``: ``Draws.get_state()``, the Philox generator's seed and
offset, where the reference stores its PRNG key). Its JSON sidecar holds
the round to resume at, the host counters, the config fingerprint and
the recorded ``TrainHistory``. Everything else a resumed trainer needs
is rebuilt from the config (eval and viz draw from per-round generators
keyed by the seed), so stopping at round R and resuming is bitwise
equal to a run that never stopped. One ``.npz`` a snapshot, written
atomically through ``checkpoint.save``, the last K kept. The key layout
is the reference's under ``state/``, ``replay/`` and ``env_states/``.

Write path: the train thread publishes ``publishable(...)`` (a clone of
every leaf enqueued on its stream and the CUDA event recorded after
them) into the host runtime's latest-wins state mailbox and goes on;
the snapshot worker waits for the event on its own stream and writes.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.core import faults
from repro_torch.train import checkpoint

SNAP_PREFIX = "snap_"
SNAP_SUFFIX = ".npz"

#: config fields a snapshot must agree on to be resumable: everything
#: that changes the math or the carried shapes, but no tunable the
#: trainer changes itself (a rollback backs ``hp.lr`` off before it
#: restores). The reference also lists ``placement``; the port has no
#: multi-device placement yet, so the field joins when that does.
_SIG_FIELDS = ("env_name", "algo", "num_envs", "batch_size",
               "replay_capacity", "chunk_len", "updates_per_round",
               "rounds_per_dispatch", "nstep", "prioritized", "per_alpha",
               "per_beta", "seed")

#: TrainHistory list fields restored as they are (the round-ordered eval
#: log)
_HIST_FIELDS = ("times", "eval_returns", "env_frames", "update_steps",
                "eval_rounds")


def snapshot_path(snap_dir: str, round_i: int) -> str:
    return os.path.join(snap_dir, f"{SNAP_PREFIX}{round_i:09d}{SNAP_SUFFIX}")


def list_snapshots(snap_dir: str) -> List[Tuple[int, str]]:
    """(round, path) pairs, oldest first."""
    if not os.path.isdir(snap_dir):
        return []
    out = []
    for f in os.listdir(snap_dir):
        if f.startswith(SNAP_PREFIX) and f.endswith(SNAP_SUFFIX):
            try:
                out.append((int(f[len(SNAP_PREFIX):-len(SNAP_SUFFIX)]),
                            os.path.join(snap_dir, f)))
            except ValueError:
                pass
    return sorted(out)


def latest(snap_dir: str) -> Optional[str]:
    snaps = list_snapshots(snap_dir)
    return snaps[-1][1] if snaps else None


def prune(snap_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    for _, path in list_snapshots(snap_dir)[:-keep]:
        try:
            os.unlink(path)
        except OSError:
            pass


def config_sig(cfg) -> str:
    return json.dumps({k: getattr(cfg, k) for k in _SIG_FIELDS},
                      sort_keys=True)


# --------------------------------------------------------------------------- #
# bundle construction / serialization
# --------------------------------------------------------------------------- #

def bundle_from(trainer) -> Dict[str, Any]:
    """Everything the next megastep reads (the live tensors)."""
    return {"state": trainer.state, "replay": trainer.replay,
            "env_states": trainer.env_states,
            "draws": trainer.draws.get_state()}


def hist_to_meta(hist) -> Dict[str, Any]:
    with hist._lock:
        d = {k: list(getattr(hist, k)) for k in _HIST_FIELDS}
    d["warmup_frames"] = int(hist.warmup_frames)
    return d


def hist_restore(hist, d: Dict[str, Any]) -> None:
    with hist._lock:
        for k in _HIST_FIELDS:
            getattr(hist, k)[:] = list(d.get(k, []))
    hist.warmup_frames = int(d.get("warmup_frames", 0))


def build_meta(trainer, hist, round_i: int) -> Dict[str, Any]:
    """The JSON sidecar: the round to resume at, the host counters, the
    config fingerprint and the recorded history."""
    return {"round_i": int(round_i),
            "total_frames": int(trainer.total_frames),
            "total_updates": int(trainer.total_updates),
            "config_sig": config_sig(trainer.cfg),
            "hist": hist_to_meta(hist) if hist is not None else {}}


class Published(NamedTuple):
    """A bundle the snapshot worker may own: clones of the live leaves,
    its sidecar, and the CUDA event recorded on the train stream after
    the clones (``None`` on the CPU)."""
    bundle: Dict[str, Any]
    meta: Dict[str, Any]
    ready: Optional[Any] = None


def publishable(trainer, hist, round_i: int) -> Published:
    """Clone every leaf on the train stream (so the next megastep may
    update the live tensors in place while the worker writes) and record
    the event that marks the clones done: launches only, no host sync.
    The draw state is read when the clones are enqueued, which is the
    state the enqueued work leaves (a CUDA generator's offset lives on
    the host)."""
    bundle = tree_map(torch.clone, bundle_from(trainer))
    ready = None
    if trainer.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return Published(bundle, build_meta(trainer, hist, round_i), ready)


def write_bundle(snap_dir: str, item, *, keep: int = 3,
                 require_finite: bool = False) -> Optional[str]:
    """Persist one ``(bundle, meta)`` item atomically, then prune to the
    last ``keep`` snapshots. With ``require_finite`` a poisoned bundle
    (one whose finite flag has not been polled yet) is skipped with a
    warning: a rollback target holding a NaN would bring back the
    divergence it rolls back from."""
    bundle, meta = item[0], item[1]
    if require_finite and not faults.finite_guard(bundle):
        warnings.warn(f"skipping snapshot at round {meta.get('round_i')}: "
                      f"bundle contains non-finite values")
        return None
    path = snapshot_path(snap_dir, int(meta["round_i"]))
    checkpoint.save(path, bundle, metadata=meta)
    prune(snap_dir, keep)
    return path


def snapshot_now(trainer, hist, round_i: int) -> Optional[str]:
    """Synchronous snapshot of the live tensors (the preemption path):
    the caller stops launching, so nothing needs a copy."""
    cfg = trainer.cfg
    return write_bundle(cfg.snapshot_dir,
                        (bundle_from(trainer),
                         build_meta(trainer, hist, round_i)),
                        keep=cfg.keep_snapshots)


# --------------------------------------------------------------------------- #
# restore
# --------------------------------------------------------------------------- #

def restore_trainer(trainer, path: str) -> Dict[str, Any]:
    """Load ``path`` into ``trainer`` and return its meta.

    Checks the config fingerprint (a bundle of another env, batch or
    capacity fails here, by name; ``checkpoint.restore`` also refuses a
    leaf whose shape or dtype drifted) and refuses a bundle with a
    non-finite value."""
    bundle, meta = checkpoint.restore(path, bundle_from(trainer))
    sig = config_sig(trainer.cfg)
    if meta.get("config_sig") != sig:
        raise checkpoint.CheckpointError(
            f"snapshot {path!r} was written by a different trainer "
            f"config:\n  snapshot: {meta.get('config_sig')}\n  "
            f"trainer:  {sig}")
    if not faults.finite_guard(bundle):
        raise faults.FiniteGuardError(
            f"snapshot {path!r} contains non-finite values: refusing to "
            f"resume from a diverged state")
    trainer.state = bundle["state"]
    trainer.replay = bundle["replay"]
    trainer.env_states = bundle["env_states"]
    trainer.draws.set_state(bundle["draws"])
    trainer.total_frames = int(meta.get("total_frames", 0))
    trainer.total_updates = int(meta.get("total_updates", 0))
    trainer.last_metrics = None
    return meta
