"""The numbers that decide ``correct`` for a training cell, each a gap
between what the program's timed path produced and what the plain
reference works out from the same inputs:

- ``loss``: each checked step's loss, the worst of them, against the
  mean magnitude of that loss over the checked steps; ``loss_first``:
  the first step's losses alone;
- ``grad``: the norm of the first gradient as the optimizer got it (from
  its first moment after one step), by the worst leaf; ``grad_median``:
  the median leaf's gap;
- ``change``: the norm of the parameters' change over the checked steps,
  by the worst leaf; ``change_median``: the median leaf's gap.

- ``outputs``: what the towers put out in the first step, row by row
  (where the runner records it), by the worst output: the root mean
  square of the program's rows less the reference's, over the root mean
  square of the reference's.

A cell compares the numbers its traffic file gives a limit.

A leaf's gap is the gap between the program's norm and the reference's,
not the norm of their difference, over the reference's norm of that leaf
or of the median leaf, whichever is larger (some gradients are all but
zero). A leaf whose reference gradient is under a thousandth of the
median leaf's moves under Adam by round-off alone: it is left out of the
change.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

QUIET = 1e-3       # a leaf's gradient under this share of the median's


def loss_gap(prog: Sequence[Sequence[float]],
             ref: Sequence[Sequence[float]]) -> float:
    """``prog[step][i]`` against ``ref[step][i]``: loss i's worst step."""
    worst = 0.0
    for i in range(len(ref[0])):
        scale = statistics.fmean(abs(r[i]) for r in ref) or 1.0
        worst = max(worst, max(abs(p[i] - r[i]) / scale
                               for p, r in zip(prog, ref)))
    return worst


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms (``keep``: the leaves compared)."""
    names = list(ref) if keep is None else list(keep)
    median = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in names}


def moving_leaves(ref_grad: Dict[str, float],
                  always: Sequence[str] = ()) -> List[str]:
    """The leaves whose change is compared: those whose reference
    gradient is at least ``QUIET`` of the median leaf's, and ``always``
    (leaves that move by another rule, such as a polyak target)."""
    median = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= QUIET * median] + \
        list(always)


def numbers(prog: dict, ref: dict, always: Sequence[str] = ()
            ) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (steps x losses),
    ``grad`` and ``change`` (leaf -> norm) -> every gap above."""
    grad = leaf_gaps(prog["grad"], ref["grad"]).values()
    change = leaf_gaps(prog["change"], ref["change"],
                       moving_leaves(ref["grad"], always)).values()
    out = {"loss": loss_gap(prog["losses"], ref["losses"]),
           "loss_first": loss_gap(prog["losses"][:1], ref["losses"][:1]),
           "grad": max(grad), "grad_median": statistics.median(grad),
           "change": max(change), "change_median": statistics.median(change)}
    if "outputs" in prog and "outputs" in ref:
        out["outputs"] = output_gap(prog["outputs"], ref["outputs"])
    return out


def output_gap(prog: Dict[str, object], ref: Dict[str, object]) -> float:
    """The worst output's RMS gap over its RMS in the reference; an output
    the program gave in another shape (rows left out) is infinitely far."""
    def rms(x):
        return float(x.double().pow(2).mean().sqrt())

    def gap(k):
        if k not in prog or prog[k].shape != ref[k].shape:
            return math.inf
        return rms(prog[k].to(ref[k].device) - ref[k]) / max(rms(ref[k]),
                                                             1e-30)
    return max(gap(k) for k in ref)
