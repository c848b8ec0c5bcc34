"""Deterministic fault injection and the device-side finite guard.
Counterpart of ``repro/core/faults.py``.

Spreeze overlaps sampler, update, eval, viz and SSD "processes" (paper
§3.1, Fig. 4), which widens the surface where one crashed or hung worker
takes down a long run. The resilience layer (the supervised workers of
``core.runtime``, the resume bundles of ``train.resume``, the rollback of
``core.pipeline``) is only trustworthy if its failure paths run, so
faults come from a declarative, round-indexed :class:`FaultPlan`, and
every injection is the same run to run (no wall clock, no random draws).

Injection points, all keyed by the train loop's round index:

- **SSD write OSError**: the SSD weight channel's materialize raises a
  transient ``OSError`` (the supervisor retries and recovers).
- **Worker exception**: the eval worker raises; ``transient`` picks the
  class (``OSError`` retries or degrades, ``ValueError`` propagates).
- **Worker hang**: the eval worker sleeps through the heartbeat timeout
  (the watchdog replaces it).
- **Preemption**: a simulated SIGTERM between megasteps; the trainer
  snapshots its whole state and raises :class:`Preempted`.
- **NaN round**: a NaN is written into the actor between megasteps; the
  megastep's ``carry_finite`` flag (a device reduction, read on the host
  only once its event has completed) trips and the trainer rolls back to
  the last snapshot with a backed-off learning rate.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.analysis.hlolint.contract import EntrypointContract
from repro_torch.distributed.sharding import to_group

#: the finite guard: a device reduction, nothing updated in place, nothing
#: moved between groups on one device, no kernel of the port's own
HLOLINT_CONTRACTS = (
    EntrypointContract(name="finite_guard", module=__name__),
)


class Preempted(RuntimeError):
    """Simulated SIGTERM between megasteps. Carries the path of the
    snapshot written on the way out and the round it resumes at, for
    ``SpreezeTrainer.train(resume_from=...)``."""

    def __init__(self, msg: str, *, snapshot_path: Optional[str] = None,
                 round_i: int = 0):
        super().__init__(msg)
        self.snapshot_path = snapshot_path
        self.round_i = round_i


class FiniteGuardError(RuntimeError):
    """The megastep carry went non-finite and recovery was impossible
    (no snapshot to roll back to, or the rollback budget is spent)."""


@dataclass(frozen=True)
class FaultPlan:
    """Declarative, reproducible fault schedule keyed by round index.

    The fused loop's round counter advances ``rounds_per_dispatch`` a
    megastep, so schedule rounds on window boundaries;
    ``preempt_round`` / ``nan_round`` fire at the first loop iteration
    whose round index reaches them. ``*_repeat`` is how often an
    injection fires at its round: the supervisor retries a failed
    snapshot, so ``repeat=1`` exercises retry-and-recover and a repeat
    above the retry budget exercises degradation."""
    ssd_oserror_rounds: Tuple[int, ...] = ()   # SSD materialize raises
    ssd_oserror_repeat: int = 1
    eval_error_rounds: Tuple[int, ...] = ()    # eval worker raises
    eval_error_repeat: int = 1
    eval_error_transient: bool = True          # OSError vs ValueError
    eval_hang_rounds: Tuple[int, ...] = ()     # eval worker sleeps
    hang_seconds: float = 1.0
    preempt_round: Optional[int] = None        # SIGTERM between megasteps
    nan_round: Optional[int] = None            # poison the actor once


class FaultClock:
    """The consumption state of one :class:`FaultPlan` for one
    ``train()``: each scheduled (point, round) fires at most ``repeat``
    times, even when the supervisor retries a snapshot or a rollback
    replays the rounds (else the NaN would re-poison every replay)."""

    def __init__(self, plan: Optional[FaultPlan]):
        self.plan = plan or FaultPlan()
        self._fired: Dict[Tuple[str, int], int] = {}

    def _consume(self, point: str, round_i: int, limit: int) -> bool:
        n = self._fired.get((point, round_i), 0)
        if n >= limit:
            return False
        self._fired[(point, round_i)] = n + 1
        return True

    # worker-side points (one snapshot is claimed at a time per consumer)
    def ssd_oserror(self, round_i: int) -> None:
        p = self.plan
        if (round_i in p.ssd_oserror_rounds
                and self._consume("ssd", round_i, p.ssd_oserror_repeat)):
            raise OSError(f"injected SSD write failure at round {round_i}")

    def eval_fault(self, round_i: int) -> None:
        p = self.plan
        if (round_i in p.eval_error_rounds
                and self._consume("eval", round_i, p.eval_error_repeat)):
            if p.eval_error_transient:
                raise OSError(f"injected transient eval failure at round "
                              f"{round_i}")
            raise ValueError(f"injected eval programming error at round "
                             f"{round_i}")
        if (round_i in p.eval_hang_rounds
                and self._consume("hang", round_i, 1)):
            time.sleep(p.hang_seconds)

    # train-thread points (between megasteps)
    def preempt(self, round_i: int) -> bool:
        p = self.plan
        return (p.preempt_round is not None and round_i >= p.preempt_round
                and self._consume("preempt", p.preempt_round, 1))

    def nan(self, round_i: int) -> bool:
        p = self.plan
        return (p.nan_round is not None and round_i >= p.nan_round
                and self._consume("nan", p.nan_round, 1))


# --------------------------------------------------------------------------- #
# device-side finite guard
# --------------------------------------------------------------------------- #

# hlolint: entrypoint[finite_guard]
def tree_finite(tree) -> torch.Tensor:
    """Bool scalar on the first leaf's device: every floating tensor leaf
    of ``tree`` is finite. Three launches for the leaves of one device
    (the leaves joined into one vector, the test, the reduction), and
    nothing read back to the host; a tree spread over a mesh's devices
    is tested device by device and the flags joined on the first."""
    by_device: Dict[torch.device, list] = {}
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            by_device.setdefault(leaf.device, []).append(leaf.reshape(-1))
    if not by_device:
        return torch.ones((), dtype=torch.bool)
    flags = [torch.isfinite(torch.cat(flat)).all()
             for flat in by_device.values()]
    if len(flags) == 1:
        return flags[0]
    home = flags[0].device
    return torch.stack([to_group(f, home) for f in flags]).all()


def finite_guard(tree) -> bool:
    """Host verdict of :func:`tree_finite`, for vetting a snapshot bundle
    at write, resume and rollback time (never on the hot loop: it
    waits for the device)."""
    return bool(tree_finite(tree))  # tracelint: allow[host-transfer] -- the host verdict at resume and rollback, off the hot loop


def poison_actor(actor):
    """``actor`` with a NaN in the first element of its first floating
    leaf: the deterministic "one update round goes non-finite"
    injection. The NaN is written into a device copy of that leaf, so a
    snapshot already published, or any other holder of the old tensor,
    keeps its values."""
    done = []

    def poison(leaf):
        if done or not (torch.is_tensor(leaf) and leaf.is_floating_point()):
            return leaf
        done.append(True)
        out = leaf.clone()
        out.view(-1)[:1].fill_(float("nan"))
        return out

    return tree_map(poison, actor)
