"""hlolint contract declarations (a dependency-free leaf module).

Counterpart of ``repro/analysis/hlolint/contract.py``. Contracts are
machine-readable claims about what one hot entry point does when it
runs, declared next to the entry point they govern (``core/pipeline.py``,
``core/faults.py``, ``kernels/ops.py``, ``train/trainer.py``,
``serve/engine.py``, ``replay/buffer.py``), so whoever edits the entry
point edits its contract in the same diff. ``python -m
repro_torch.analysis.hlolint`` runs each declared entry point at a probe
size and checks five rule families against what the run did
(``checks.py``); the builders that make each run live in
``entrypoints.py``.

The reference checks a compiled artifact. The port has none, so its
contract speaks of the run: the state updated in place (the reference's
donation), the tensors ``distributed.sharding.to_group`` moves between
groups (its collectives), the dtypes the ops make, the host reads, and
each hand-written kernel's calls per dispatch (its retrace budget).

This module imports nothing but the standard library: the hot modules
import it at module scope.

**Shape expressions.** Move shapes and launch counts depend on the
probe's parameters (replay capacity, batch size, batch groups, rounds,
layers), so contracts give them as arithmetic expressions over the
builder's symbol table (``"groups*k"``, ``"batch//groups"``); in a
``CollectiveRule`` a ``"*"`` dim matches any one dim and a trailing
``"..."`` any remaining dims.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

#: rule-family ids, mirrored by the CLI summary and the fixture tests
RULES = (
    "inplace",         # declared state leaves keep their storage
    "collective",      # to_group move shapes within the declared budget
    "dtype",           # no f64 anywhere; float dtypes from the declared set
    "host-read",       # no read of a device value on the host
    "launches",        # each kernel's calls per dispatch as declared
    "coverage",        # every in-place hot site carries a contract
    "contract-error",  # the contract itself is broken (exit 2)
)

#: dtypes banned from every run whatever ``float_dtypes`` says: one
#: float64 upcast doubles the bytes of everything downstream of it
BANNED_DTYPES = ("float64", "complex64", "complex128")

#: the kind every port move has: all cross-group traffic is ``to_group``
MOVE = "to_group"

_EXPR_RE = re.compile(r"^[\sa-zA-Z_0-9+\-*/()%]+$")


def eval_dim(expr: str, params: Dict[str, int]) -> int:
    """Evaluate one dim expression over the builder's symbol table.

    Supports ints, identifiers from ``params``, ``+ - * // / %`` and
    parentheses: enough for ``"groups*k"`` / ``"batch//groups"``
    without admitting arbitrary code."""
    if not _EXPR_RE.match(expr):
        raise ValueError(f"bad dim expression {expr!r}")
    try:
        val = eval(expr, {"__builtins__": {}}, dict(params))  # noqa: S307
    except NameError as e:
        raise ValueError(f"dim expression {expr!r}: {e}") from None
    ival = int(val)
    if ival != val:
        raise ValueError(f"dim expression {expr!r} is not integral "
                         f"({val}) — use // for division")
    return ival


@dataclass(frozen=True)
class CollectiveRule:
    """One allowed move shape.

    ``kind`` is the move's kind (``"to_group"``: the port has one) or
    ``"*"``. ``dims`` entries are dim expressions, ``"*"`` (any one dim),
    or a trailing ``"..."``.

    ``cap_exempt`` lifts the contract's ``max_elems`` cap for shapes this
    rule matches: for traffic whose size is unrelated to the capped
    quantity (parameter-shaped gradient sums against a replay-capacity
    cap). Keep exempt rules as shape-specific as possible: an exempt
    wildcard is a hole in the cap."""
    kind: str
    dims: Tuple[str, ...]
    cap_exempt: bool = False

    def matches(self, kind: str, shape: Sequence[int],
                params: Dict[str, int]) -> bool:
        if self.kind != "*" and kind != self.kind:
            return False
        dims = list(self.dims)
        tail = dims and dims[-1] == "..."
        if tail:
            dims = dims[:-1]
        if tail:
            if len(shape) < len(dims):
                return False
        elif len(shape) != len(dims):
            return False
        for want, got in zip(dims, shape):
            if want == "*":
                continue
            if eval_dim(want, params) != got:
                return False
        return True


@dataclass(frozen=True)
class CollectiveContract:
    """An entry point's budget of moves between groups.

    A move's shape passes iff it matches an ``allow`` rule (rank-0 moves,
    scalars, always pass) AND its element count stays below
    ``max_elems`` (an expression, typically ``"capacity"``: nothing that
    crosses between groups may be as large as the replay pool) unless
    the matching rule is ``cap_exempt``. ``max_elems=None`` disables the
    cap."""
    allow: Tuple[CollectiveRule, ...] = ()
    max_elems: Optional[str] = None

    def check(self, shapes: Sequence[Tuple[str, Tuple[int, ...]]],
              params: Dict[str, int]):
        """-> list of (kind, shape, why) violations."""
        bad = []
        cap = (eval_dim(self.max_elems, params)
               if self.max_elems is not None else None)
        for kind, shape in shapes:
            rule = next((r for r in self.allow
                         if shape and r.matches(kind, shape, params)), None)
            if not shape:
                continue                 # a scalar: always allowed
            if rule is None:
                bad.append((kind, shape, "matches no allow rule"))
                continue
            elems = math.prod(shape)
            if cap is not None and elems >= cap and not rule.cap_exempt:
                bad.append((kind, shape,
                            f"result has {elems} elems >= max_elems "
                            f"{self.max_elems}={cap}"))
        return bad


@dataclass(frozen=True)
class EntrypointContract:
    """What one hot entry point may do in a run.

    ``name`` keys the builder in ``entrypoints.BUILDERS`` (or a fixture
    module's ``BUILDERS``) and the ``# hlolint: entrypoint[name]``
    annotation at the entry point's ``def``."""
    name: str
    module: str                   # dotted module of the entry point
    # in place: the named parts of the builder's state (``state``) are
    # updated in place, so at least ``min_inplace_fraction`` of their
    # tensor leaves keep their storage across the drive's dispatches (the
    # reference's donation); tracelint's inplace-alias rule reads the
    # same names
    inplace: bool = False
    min_inplace_fraction: float = 1.0
    state: Tuple[str, ...] = ()
    # the moves between groups; the empty default allows none but scalars
    collectives: CollectiveContract = field(
        default_factory=CollectiveContract)
    # float dtypes the run's ops may make (``torch.dtype`` names);
    # BANNED_DTYPES are rejected even if listed here
    float_dtypes: Tuple[str, ...] = ("float32",)
    # no host read during a dispatch; opt out only for a host-side path
    hot: bool = True
    # each hand-written kernel's calls per dispatch, a dim expression a
    # kernel (``LAUNCH_COUNTS``' names); a kernel not named must not run
    launches: Dict[str, str] = field(default_factory=dict)
    drive_dispatches: int = 3

    def site(self) -> str:
        return f"{self.module}:{self.name}"
