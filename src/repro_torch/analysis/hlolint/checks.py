"""hlolint rule families: checks of one entry point's run. Counterpart of
``repro/analysis/hlolint/checks.py``.

The reference lowers and compiles an entry point and reads the artifact.
The port has no artifact, so ``run_contract`` runs the entry point: its
builder makes it at a probe size on the device asked for, and the harness
drives ``drive_dispatches`` dispatches while it watches them:

- ``OpCensus`` (``launch.analysis``) sees every aten op: its output
  dtypes, the op count of each dispatch, and every ``to_group`` move, of
  which ``_RunCensus`` also keeps the shape between its two groups;
- ``_HostReads``, a ``TorchDispatchMode``, sees every op that hands a
  device value to the host (``aten._local_scalar_dense``: ``.item()``,
  ``float()``, ``int()``, ``bool()``; ``aten.is_nonzero``;
  ``aten.equal``; a copy from a device tensor to the host; and the ops
  whose output size the host must wait for: ``nonzero``,
  ``masked_select``), and on the card the drive runs under
  ``repro_torch.sync_debug_mode(dev, "error")`` as well, so any wait for
  the card raises;
- each hand-written kernel's calls: from a second build of the entry
  point on the meta device, whose kernel routes report each call to the
  census (``kernels.work.recording``), and on the card from
  ``LAUNCH_COUNTS`` too;
- the in-place state's storage addresses before and after the drive.

The five families: ``inplace`` (the reference's donation), ``collective``,
``dtype``, ``host-read`` (its host-callback), ``launches`` (its retrace).
``capacity_offenders`` and ``shape_delta`` are the reference's pure
helpers over (kind, shape) censuses, kept as they are.
"""
from __future__ import annotations

import collections
import contextlib
import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device, sync_debug_mode
from repro_torch._tree import tree_leaves
from repro_torch.analysis.hlolint.contract import (BANNED_DTYPES, MOVE,
                                                   EntrypointContract,
                                                   eval_dim)
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.launch.analysis import OpCensus

META = torch.device("meta")

#: float dtypes subject to the contract's ``float_dtypes`` (integer and
#: bool outputs are free: indices and flags are whatever they need)
_FLOAT_DTYPES = ("float8_e4m3fn", "float8_e5m2", "bfloat16", "float16",
                 "float32", "float64", "complex64", "complex128")

_aten = torch.ops.aten
#: ops that hand a device value to the host whatever their operands
_HOST_OPS = {_aten._local_scalar_dense.default: "item/float/int/bool",
             _aten.is_nonzero.default: "is_nonzero",
             _aten.equal.default: "equal",
             _aten.nonzero.default: "nonzero (its size)",
             _aten.masked_select.default: "masked_select (its size)"}
#: copies, read as host reads when they take a device tensor to the host
_COPY_OPS = (_aten._to_copy.default, _aten.copy_.default)


@dataclass(frozen=True, order=True)
class Finding:
    entrypoint: str      # contract name (module:name printed by the CLI)
    rule: str
    msg: str

    def format(self) -> str:
        return f"{self.entrypoint}: [{self.rule}] {self.msg}"


# --------------------------------------------------------------------------- #
# what a run is watched with
# --------------------------------------------------------------------------- #

class _RunCensus(OpCensus):
    """An ``OpCensus`` without the FLOP formulas that also keeps each
    move's shape between its groups: ``move_log`` holds (source, destination, shape) of every
    ``to_group`` between two different groups. A tensor the census has
    not tagged counts as on the first grid position of its device (the
    primary (0, 0) on a grid that repeats one device: where the sampler,
    the draws and the ring's cursor live)."""

    def __init__(self, args: Any = ()):
        super().__init__(args, flops=False)
        self.move_log: List[Tuple[Any, Any, Tuple[int, ...]]] = []
        self._home: Dict[torch.device, Tuple[int, int]] = {}

    def watch(self, mesh) -> None:
        super().watch(mesh)
        for a, row in enumerate(mesh.grid):
            for b, dev in enumerate(row):
                self._home.setdefault(dev, (a, b))

    @contextlib.contextmanager
    def placing(self):
        """``OpCensus.placing``: set-up moves, none of them logged."""
        n = len(self.move_log)
        with super().placing():
            yield
        del self.move_log[n:]

    def _group(self, x):
        if isinstance(x, torch.Tensor):
            tag = self._tags.get(x)
            return tag if tag is not None else self._home.get(x.device)
        return self._positions.get(id(x), self._home.get(x))

    def _move(self, leaf, dest, out):
        if isinstance(leaf, torch.Tensor):
            src, dst = self._group(leaf), self._group(dest)
            if src is not None and dst is not None and src != dst:
                self.move_log.append((src, dst, tuple(leaf.shape)))
        return super()._move(leaf, dest, out)


class _HostReads(TorchDispatchMode):
    """Records every op of the block that reads a device value on the
    host (``_HOST_OPS``, and a copy from a non-CPU tensor to the CPU),
    then runs it."""

    def __init__(self):
        super().__init__()
        self.reads: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_OPS:
            self.reads[_HOST_OPS[func]] += 1
        elif func in _COPY_OPS and _to_host(func, args, kwargs):
            self.reads["copy to the host"] += 1
        return func(*args, **kwargs)


def _to_host(func, args, kwargs) -> bool:
    if func is _aten._to_copy.default:
        src, dst = args[0], kwargs.get("device")
        return (dst is not None and torch.device(dst).type == "cpu"
                and src.device.type != "cpu")
    dst, src = args[0], args[1]
    return (isinstance(src, torch.Tensor) and dst.device.type == "cpu"
            and src.device.type != "cpu")


def _state_ptrs(state: Dict[str, Any], names: Sequence[str]
                ) -> Dict[Tuple[str, int], int]:
    """Each tensor leaf of the named state's storage address."""
    out = {}
    for name in names:
        leaves = [t for t in tree_leaves(state[name]) if torch.is_tensor(t)]
        for i, t in enumerate(leaves):
            out[(name, i)] = t.untyped_storage().data_ptr()
    return out


def _misses() -> int:
    from repro_torch.kernels import _build
    return _build.load_kernels.cache_info().misses


@dataclass
class Drive:
    """What the drive of one build saw, dispatch by dispatch."""
    ops: List[int]                          # aten ops
    kernel_calls: List[Dict[str, int]]      # meta routes' calls
    launches: List[Dict[str, int]]          # LAUNCH_COUNTS (the card)
    misses: List[int]                       # the kernel build's cache
    census: _RunCensus
    reads: collections.Counter
    error: Optional[BaseException] = None


def drive(built: Dict, census: _RunCensus, device: torch.device,
          n: int, hot: bool = True) -> Drive:
    """``n`` dispatches of a built entry point under the census and the
    host-read mode (on the card under the sync debug mode "error" too,
    restored on the way out). An exception ends the drive and is kept."""
    out = Drive([], [], [], [], census, collections.Counter())
    reads = _HostReads()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(census)
            stack.enter_context(reads)
            if hot:
                stack.enter_context(sync_debug_mode(device, "error"))
            for _ in range(n):
                ops0, calls0 = census.ops, dict(census.kernel_calls)
                launch0 = dict(LAUNCH_COUNTS)
                built["dispatch"]()
                out.ops.append(census.ops - ops0)
                out.kernel_calls.append(
                    {k: v - calls0.get(k, 0)
                     for k, v in census.kernel_calls.items()
                     if v - calls0.get(k, 0)})
                out.launches.append(
                    {k: v - launch0.get(k, 0) for k, v in LAUNCH_COUNTS.items()
                     if v - launch0.get(k, 0)})
                if device.type == "cuda":
                    out.misses.append(_misses())
    except Exception as e:           # the run broke: kept for the report
        out.error = e
    out.reads = reads.reads
    return out


# --------------------------------------------------------------------------- #
# rule family 1: in-place state
# --------------------------------------------------------------------------- #

def check_inplace(contract: EntrypointContract,
                  before: Dict[Tuple[str, int], int],
                  after: Dict[Tuple[str, int], int]) -> List[Finding]:
    """The declared state's tensor leaves must keep their storage across
    the drive: a leaf that moved was rebuilt, so every dispatch pays a
    copy of it (the port's form of a donated buffer that did not
    alias)."""
    if not contract.inplace:
        return []
    if not before:
        return [Finding(contract.name, "inplace",
                        "contract declares inplace=True but the builder's "
                        "state has no tensor leaves")]
    kept = sum(1 for k, p in before.items() if after.get(k) == p)
    frac = kept / len(before)
    if frac < contract.min_inplace_fraction:
        moved = sorted({k[0] for k, p in before.items()
                        if after.get(k) != p})
        return [Finding(
            contract.name, "inplace",
            f"only {kept}/{len(before)} state leaves kept their storage "
            f"over {contract.drive_dispatches} dispatches ({frac:.2f} < "
            f"min_inplace_fraction {contract.min_inplace_fraction:.2f}; "
            f"rebuilt: {', '.join(moved)}) — the rebuilt leaves are "
            f"copied every dispatch")]
    return []


# --------------------------------------------------------------------------- #
# rule family 2: moves between groups
# --------------------------------------------------------------------------- #

def check_collectives(contract: EntrypointContract,
                      shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                      params: Dict[str, int]) -> List[Finding]:
    try:
        bad = contract.collectives.check(sorted(set(shapes)), params)
    except ValueError as e:          # a broken dim expression
        return [Finding(contract.name, "contract-error", str(e))]
    return [Finding(contract.name, "collective",
                    f"{kind} move {'x'.join(map(str, shape)) or 'scalar'} "
                    f"off-budget: {why}")
            for kind, shape, why in bad]


def capacity_offenders(shapes: Sequence[Tuple[str, Sequence[int]]],
                       capacity: int) -> List[Tuple[str, List[int]]]:
    """The reference's predicate, shared: the (kind, shape) entries whose
    element count is >= the replay capacity (a capacity-sized move on the
    PER path means the selection went global again)."""
    return [(kind, list(dims)) for kind, dims in shapes
            if math.prod(dims) >= capacity]


def shape_delta(per: Sequence[Tuple[str, Sequence[int]]],
                base: Sequence[Tuple[str, Sequence[int]]]
                ) -> List[Tuple[str, List[int]]]:
    """Multiset difference per - base of (kind, dims) censuses: the moves
    one arm adds over another, with multiplicity."""
    def key(s):
        return (s[0], tuple(s[1]))
    delta = collections.Counter(map(key, per))
    delta.subtract(collections.Counter(map(key, base)))
    return [(kind, list(dims)) for (kind, dims), c in delta.items()
            if c > 0 for _ in range(c)]


# --------------------------------------------------------------------------- #
# rule family 3: dtypes
# --------------------------------------------------------------------------- #

def check_dtypes(contract: EntrypointContract,
                 census: Dict[str, int]) -> List[Finding]:
    """``census``: dtype name -> ops that made an output of it."""
    out: List[Finding] = []
    for dt in BANNED_DTYPES:
        if census.get(dt):
            out.append(Finding(
                contract.name, "dtype",
                f"{dt} made by {census[dt]} ops of the run — banned "
                f"port-wide (a silent upcast doubles the bytes)"))
    allowed = set(contract.float_dtypes)
    for dt in _FLOAT_DTYPES:
        if dt in BANNED_DTYPES or dt in allowed:
            continue
        if census.get(dt):
            out.append(Finding(
                contract.name, "dtype",
                f"{dt} made by {census[dt]} ops but the contract declares "
                f"float_dtypes={tuple(sorted(allowed))}"))
    return out


# --------------------------------------------------------------------------- #
# rule family 4: host reads
# --------------------------------------------------------------------------- #

def check_host_reads(contract: EntrypointContract,
                     reads: collections.Counter,
                     error: Optional[BaseException]) -> List[Finding]:
    """Any op that read a device value on the host during the drive, and
    on the card a wait the sync debug mode refused."""
    if not contract.hot:
        return []
    out = [Finding(contract.name, "host-read",
                   f"{what} x{n} during the drive of a hot entry point — "
                   f"every dispatch waits for the device")
           for what, n in sorted(reads.items())]
    if error is not None and _is_sync_error(error):
        out.append(Finding(contract.name, "host-read",
                           f"the sync debug mode refused a wait: "
                           f"{str(error).splitlines()[0]}"))
    return out


def _is_sync_error(e: BaseException) -> bool:
    return "synchroniz" in str(e)


# --------------------------------------------------------------------------- #
# rule family 5: kernel launches
# --------------------------------------------------------------------------- #

def expected_launches(contract: EntrypointContract,
                      params: Dict[str, int]) -> Dict[str, int]:
    """The contract's calls per dispatch, each expression evaluated;
    raises ValueError on a broken one."""
    return {k: eval_dim(v, params) for k, v in contract.launches.items()}


def check_launches(contract: EntrypointContract, params: Dict[str, int],
                   meta_calls: Sequence[Dict[str, int]],
                   ops: Sequence[int],
                   card_launches: Optional[Sequence[Dict[str, int]]] = None,
                   misses: Sequence[int] = ()) -> List[Finding]:
    """Each kernel's calls in every dispatch equal the contract's
    expression (from the meta census; on the card from ``LAUNCH_COUNTS``
    too), a kernel the contract does not name runs no time, every
    dispatch runs as many aten ops as the first, and the kernel build is
    not redone after the first dispatch."""
    try:
        want = expected_launches(contract, params)
    except ValueError as e:
        return [Finding(contract.name, "contract-error", str(e))]
    out: List[Finding] = []

    def per_dispatch(seen: Sequence[Dict[str, int]], source: str):
        for i, got in enumerate(seen):
            for k in sorted(set(want) | set(got)):
                if got.get(k, 0) != want.get(k, 0):
                    out.append(Finding(
                        contract.name, "launches",
                        f"{k}: {got.get(k, 0)} calls in dispatch {i} "
                        f"({source}) but the contract declares "
                        f"{contract.launches.get(k, '0')}="
                        f"{want.get(k, 0)}"))
    per_dispatch(meta_calls, "meta census")
    if card_launches is not None:
        per_dispatch(card_launches, "LAUNCH_COUNTS")
    if len(set(ops)) > 1:
        out.append(Finding(
            contract.name, "launches",
            f"aten ops per dispatch vary {list(ops)} — the entry point "
            f"does not run the same work at every dispatch"))
    if len(set(misses)) > 1:
        out.append(Finding(
            contract.name, "launches",
            f"the kernel build's cache missed again during the drive "
            f"({list(misses)}) — the kernels were rebuilt"))
    return sorted(set(out))


# --------------------------------------------------------------------------- #
# harness: run one contract end to end
# --------------------------------------------------------------------------- #

@dataclass
class Report:
    """What ``run_contract`` measured, for a caller's report line."""
    name: str
    device: str
    expected: Dict[str, int]
    meta_calls: Dict[str, int]
    card_launches: Optional[Dict[str, int]]
    ops: Optional[int]
    dispatches: int
    moves: int


def _build(builder: Callable, device: torch.device):
    census = _RunCensus()
    return builder(device, census), census


def _first(seq, default=None):
    return seq[0] if seq else default


def run_contract(contract: EntrypointContract,
                 builder: Callable[[torch.device, Any], Dict],
                 device="cuda") -> Tuple[List[Finding], Optional[Report]]:
    """Build, drive and check one declared entry point on ``device`` (the
    card unless the caller asks for ``cpu`` or ``meta``).

    ``builder(device, census) -> dict`` makes the entry point at its
    probe size on ``device`` (a builder on a mesh names its groups to the
    census, ``census.watch(mesh)``, and places its state under
    ``census.placing()``), with keys:

    * ``dispatch``: a callable that runs one dispatch, threading the
      state from one to the next;
    * ``state``: a callable -> {name: tree} of the state the contract's
      ``state`` names;
    * ``params``: the symbol table of the contract's expressions.

    The builder is called twice: on ``device`` for the checks of the run,
    and on ``meta`` for the kernel calls (the same build when ``device``
    is meta). -> (findings, report); the report is None when a build
    broke (a contract-error)."""
    dev = resolve_device(device)
    name, n = contract.name, contract.drive_dispatches
    try:
        built, census = _build(builder, dev)
        params = dict(built.get("params", {}))
        if dev.type == "meta":
            meta_built, meta_census = built, census
        else:
            meta_built, meta_census = _build(builder, META)
        state = built["state"]() if contract.state else {}
        missing = [s for s in contract.state if s not in state]
        if missing:
            raise KeyError(f"the builder's state lacks {missing}")
    except Exception as e:           # the builder broke: contract error
        return [Finding(name, "contract-error",
                        f"builder failed: {type(e).__name__}: {e}")], None

    on_address = contract.inplace and dev.type != "meta"
    before = _state_ptrs(state, contract.state) if on_address else {}
    run = drive(built, census, dev, n, contract.hot)
    meta_run = run if meta_built is built else drive(
        meta_built, meta_census, META, n, hot=False)

    findings: List[Finding] = []
    findings += check_host_reads(contract, run.reads, run.error)
    if run.error is not None and not findings:
        findings.append(Finding(name, "contract-error",
                                f"drive failed: {type(run.error).__name__}: "
                                f"{run.error}"))
    if (meta_run is not run and meta_run.error is not None
            and not meta_run.reads):      # a host read stops meta too
        findings.append(Finding(
            name, "contract-error", f"meta drive failed: "
            f"{type(meta_run.error).__name__}: {meta_run.error}"))
    if run.error is None:
        if on_address:
            findings += check_inplace(contract, before,
                                      _state_ptrs(built["state"](),
                                                  contract.state))
        findings += check_collectives(
            contract, [(MOVE, shape) for _, _, shape in census.move_log],
            params)
        findings += check_dtypes(contract, {
            str(k).replace("torch.", ""): v for k, v in census.dtypes.items()})
    if run.error is None and meta_run.error is None:
        findings += check_launches(
            contract, params, meta_run.kernel_calls, run.ops,
            run.launches if dev.type == "cuda" else None, run.misses)
    try:
        expected = expected_launches(contract, params)
    except ValueError:
        expected = {}
    report = Report(
        name=name, device=str(dev), expected=expected,
        meta_calls=_first(meta_run.kernel_calls, {}),
        card_launches=(_first(run.launches, {}) if dev.type == "cuda"
                       else None),
        ops=_first(run.ops), dispatches=len(run.ops),
        moves=len(census.move_log))
    return sorted(set(findings)), report
