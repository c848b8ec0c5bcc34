"""The trainer's ("ac", "batch") mesh and its placement rules.
Counterpart of the trainer half of ``repro/distributed/sharding.py``.

The port runs a mesh from one controller: one Python process holds a grid
of ``torch.device`` named ``("ac", "batch")`` and launches every group's
work on that group's device. There is no SPMD program and no process
group: where the reference's ``shard_map`` runs a body per device and
its collectives join them, the port loops over the groups and moves
tensors between them explicitly. Every such move goes through
``to_group``, so all of them can be audited in one place.

A grid may name one device more than once (``cuda:0`` four times is a
2x2 mesh on one card). That one-card stand-in runs every group's kernels
on real shards with real window offsets, and every combine step; it
cannot show that no tensor sits on the wrong card, nor anything about
the speed of two cards. ``check_on_group`` is the host-side check that
catches a misplaced operand on a machine with several cards.

``MeshRules`` keeps the reference's names: ``batch`` is the tuple of mesh
axes the replay ring's rows and the update's batch are split over, and
``ac`` the axis the double-Q ensemble is split over (``None`` under the
data-parallel placement); ``seq``, ``fsdp`` and ``tp`` are the
reference's sequence, parameter-over-data and parameter-over-model axes.

The reference's production rules come too, for the dry run
(``launch/dryrun.py``): ``AxisMesh`` is a mesh of axis sizes with no
devices (the counterpart of JAX's ``AbstractMesh``), and
``standard_rules``, ``spreeze_rules``, ``param_spec`` and
``params_sharding_tree`` give each leaf's split as a tuple of one entry a
dimension (``None``, an axis name or a tuple of them), the counterpart of
a ``PartitionSpec``. The port runs no SPMD program, so nothing applies
them; the dry run reads from them what a device would hold. (The
reference's ``shard`` and ``shard_param_like``, which constrain an SPMD
program, have no counterpart.)

``moves`` lets a census see every ``to_group`` (``launch.analysis``): on
a grid that names one device more than once a move returns the very
tensor, so the census tells the groups apart by where each tensor was
placed, not by its device. A destination may be given as a tensor: the
device and the group that tensor sits on.
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch._tree import tree_leaves, tree_map

def _normalize(device) -> torch.device:
    """A ``torch.device`` as a tensor's ``.device`` names it: a CUDA device
    without an index is the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ``(ac, batch)`` grid of devices, row-major: ``grid[a][b]`` is the
    device of ac row ``a``, batch column ``b``. A device may appear more
    than once."""

    axis_names = ("ac", "batch")

    def __init__(self, grid: Sequence[Sequence[Union[str, torch.device]]]):
        rows = [[_normalize(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                           for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(r) for r in rows)
        self.shape: Dict[str, int] = {"ac": len(rows), "batch": len(rows[0])}

    def device(self, ac: int = 0, batch: int = 0) -> torch.device:
        return self.grid[ac][batch]

    @property
    def primary(self) -> torch.device:
        """Device ``(0, 0)``: the sampler, the draws, the ring's cursor and
        the whole-state view live here."""
        return self.grid[0][0]

    @property
    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in itertools.chain.from_iterable(self.grid):
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh(ac={self.shape['ac']}, batch={self.shape['batch']}, "
                f"devices={[str(d) for r in self.grid for d in r]})")


class AxisMesh:
    """A mesh of named axis sizes and no devices: the shape a sharding rule
    reads (the counterpart of JAX's ``AbstractMesh``)."""

    def __init__(self, axes: Dict[str, int]):
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(axes)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"AxisMesh({self.shape})"


Physical = Union[str, None, Tuple[str, ...]]


@dataclass(frozen=True)
class MeshRules:
    mesh: Optional[Union[Mesh, AxisMesh]] = None
    batch: Optional[Tuple[str, ...]] = None   # axes the rows split over
    seq: Optional[str] = None                 # the sequence dim's axis
    fsdp: Optional[str] = None                # a parameter dim over data
    tp: Optional[str] = None                  # a parameter dim over model
    ac: Optional[str] = None                  # axis of the Q ensemble

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def axis_size(self, physical: Physical) -> int:
        if physical is None or self.mesh is None:
            return 1
        if isinstance(physical, str):
            physical = (physical,)
        n = 1
        for a in physical:
            n *= self.mesh.shape[a]
        return n


def standard_rules(mesh: Optional[AxisMesh], *,
                   sequence_parallel: bool = True, fsdp: bool = True,
                   tensor_parallel: bool = True,
                   data_axes: Optional[Tuple[str, ...]] = None
                   ) -> MeshRules:
    """The reference's mapping for a ("data", "model") or ("pod", "data",
    "model") mesh: the batch over the data axes, the sequence over
    ``model``, a parameter dim over ``data`` (fsdp) and one over ``model``
    (tp), the actor/critic ensemble over ``pod``."""
    if mesh is None:
        return MeshRules()
    has_pod = "pod" in mesh.axis_names
    batch = data_axes or (("pod", "data") if has_pod else ("data",))
    return MeshRules(mesh=mesh, batch=batch,
                     seq="model" if sequence_parallel else None,
                     fsdp="data" if fsdp else None,
                     tp="model" if tensor_parallel else None,
                     ac="pod" if has_pod else None)


def spreeze_rules(mesh: AxisMesh, **kw) -> MeshRules:
    """Spreeze AC model parallelism: the pod axis splits the actor/critic
    ensemble instead of the batch (paper §3.2.2, dual-GPU -> dual-pod)."""
    r = standard_rules(mesh, data_axes=("data",), **kw)
    return replace(r, ac="pod" if "pod" in mesh.axis_names else None)


def param_spec(shape: Sequence[int], *, stacked: bool = False,
               rules: MeshRules, expert_dim: Optional[int] = None
               ) -> Tuple[Physical, ...]:
    """The reference's greedy 2-D parameter split ("fsdp2d"): the largest
    dims first, the first divisible by the data axis's size takes
    ``fsdp``, the next divisible by the model axis's size ``tp``.
    ``stacked`` keeps dim 0 (the layers) whole; ``expert_dim`` marks a MoE
    expert dim that takes the model axis when divisible. -> one entry a
    dim."""
    spec: List[Physical] = [None] * len(shape)
    if not rules.active:
        return tuple(spec)
    fs, ts = rules.axis_size(rules.fsdp), rules.axis_size(rules.tp)
    tp_done = fsdp_done = False
    if expert_dim is not None and rules.tp and shape[expert_dim] % ts == 0:
        spec[expert_dim] = rules.tp
        tp_done = True
    order = sorted(range(1 if stacked else 0, len(shape)),
                   key=lambda i: -shape[i])
    for i in order:
        if spec[i] is not None:
            continue
        if not fsdp_done and rules.fsdp and shape[i] % fs == 0:
            spec[i] = rules.fsdp
            fsdp_done = True
        elif not tp_done and rules.tp and shape[i] % ts == 0:
            spec[i] = rules.tp
            tp_done = True
    return tuple(spec)


def map_with_keys(fn, tree, keys: Tuple = ()):
    """``fn(keys, leaf)`` over a tree, the keys as the reference's
    ``params_sharding_tree`` reads a JAX key path: a dict key, a sequence
    index, and ``""`` for a NamedTuple field."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, keys + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        named = hasattr(tree, "_fields")
        out = [map_with_keys(fn, v, keys + ("" if named else i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if named else type(tree)(out)
    return fn(keys, tree)


def params_sharding_tree(params, rules: MeshRules):
    """Each leaf's ``param_spec``: stacked (per-layer) leaves are those
    whose path holds "layers" or "blocks", MoE expert leaves those whose
    name starts with "moe_w" or "expert" (the expert dim after the layer
    dim). Leaves are tensors or anything with a ``shape``."""
    def one(keys, leaf):
        shape = tuple(leaf.shape)
        if not rules.active:
            return (None,) * len(shape)
        spath = "/".join(str(k) for k in keys)
        stacked = "layers" in spath or "blocks" in spath
        name = str(keys[-1]) if keys else ""
        expert_dim = None
        if name.startswith("moe_w") or name.startswith("expert"):
            expert_dim = 1 if stacked else 0
            if shape[expert_dim] % rules.axis_size(rules.tp):
                expert_dim = None      # intra-expert tp instead
        return param_spec(shape, stacked=stacked, rules=rules,
                          expert_dim=expert_dim)

    return map_with_keys(one, params)


def shard_counts(spec: Sequence[Physical], rules: MeshRules) -> int:
    """Into how many pieces a leaf of split ``spec`` is cut: the product
    of the sizes of the axes its dims take."""
    n = 1
    for axes in spec:
        n *= rules.axis_size(axes)
    return n


def trainer_rules(mesh: Mesh, placement: str = "ac") -> MeshRules:
    """Rules for the trainer's ("ac", "batch") mesh.

    placement="ac" (paper Fig. 2b): the double-Q ensemble is split over
    the ``ac`` axis (each ac row owns its towers) and the replay rows over
    ``batch``. placement="dp" (Fig. 2a baseline): no ensemble axis; every
    parameter is replicated and the rows are split over both axes (the
    gradients are summed over every group)."""
    names = mesh.axis_names
    if placement == "dp":
        batch = tuple(a for a in ("ac", "batch") if a in names) or names
        return MeshRules(mesh=mesh, batch=batch, ac=None)
    if placement != "ac":
        raise ValueError(f"unknown placement {placement!r} (want ac|dp)")
    return MeshRules(mesh=mesh,
                     batch=("batch",) if "batch" in names else None,
                     ac="ac" if "ac" in names else None)


# The candidate-merge order of the sharded PER selection: the groups'
# ``(groups * k,)`` candidates are concatenated in ``group_devices``'
# order, which is ``batch_group_index``'s row-major order over
# ``batch_axes`` (first axis most significant), and
# ``merge_topk_candidates`` relies on that order for its tie-breaking (an
# equal score keeps the lower group's candidate first, so the merge
# equals the dense top-k). Changing one of the three means changing all
# of them, and this constant.
ALLGATHER_CANDIDATE_CONTRACT = {
    "axes_from": "batch_axes",
    "order": "row-major",
    "merge": "merge_topk_candidates",
}


def batch_axes(rules: MeshRules) -> Tuple[str, ...]:
    """The mesh axes the ``batch`` dim maps to, as a tuple (empty when
    unmapped): the axes the ring's rows are split over."""
    b = rules.batch
    if b is None:
        return ()
    return (b,) if isinstance(b, str) else tuple(b)


def axis_index(position: Dict[str, int], axis: str) -> int:
    """A mesh position's index along ``axis`` (the counterpart of
    ``jax.lax.axis_index`` inside ``shard_map``)."""
    return position[axis]


def batch_group_index(rules: MeshRules, ac: int = 0, batch: int = 0) -> int:
    """Flat index of the batch group at mesh position ``(ac, batch)``:
    row-major over ``batch_axes`` (first axis most significant), as the
    reference's. Group g holds ring slots ``[g * rows, (g + 1) * rows)``
    and its PER candidates come g-th in the merge."""
    position = {"ac": ac, "batch": batch}
    idx = 0
    for a in batch_axes(rules):
        idx = idx * rules.mesh.shape[a] + axis_index(position, a)
    return idx


def group_devices(rules: MeshRules) -> List[torch.device]:
    """The batch groups' devices in ``batch_group_index`` order; a mesh
    axis outside ``batch_axes`` stays at index 0 (under ``ac`` the groups
    are ac row 0's devices)."""
    mesh, axes = rules.mesh, batch_axes(rules)
    out = {}
    for a in range(mesh.shape["ac"] if "ac" in axes else 1):
        for b in range(mesh.shape["batch"] if "batch" in axes else 1):
            out[batch_group_index(rules, a, b)] = mesh.device(a, b)
    return [out[g] for g in range(len(out))]


_MOVE_HOOKS: List = []


@contextlib.contextmanager
def moves(hook) -> Iterator:
    """While the block runs, every leaf ``to_group`` moves goes through
    ``hook(leaf, dest, out) -> out``: ``dest`` as the caller gave it (a
    device or a tensor), ``out`` the moved leaf, which the hook may
    replace by an alias of it."""
    _MOVE_HOOKS.append(hook)
    try:
        yield hook
    finally:
        _MOVE_HOOKS.remove(hook)


def to_group(tree, device, *, copy: bool = False):
    """THE cross-group move: every leaf of ``tree`` onto ``device`` (a
    device, or a tensor: onto its device and group) with ``.to(device,
    non_blocking=True)``. On the same device the leaf comes back as it is
    (no copy), unless ``copy`` asks for a fresh tensor, as placing
    replicas does. A caller that combines several groups' tensors must
    write into fresh outputs: on a repeated device two groups' "copies"
    are one tensor."""
    dest = device.device if torch.is_tensor(device) else device
    if not _MOVE_HOOKS:
        return tree_map(lambda t: t.to(dest, non_blocking=True, copy=copy),
                        tree)
    hook = _MOVE_HOOKS[-1]
    return tree_map(lambda t: hook(t, device, t.to(dest, non_blocking=True,
                                                   copy=copy)), tree)


def sum_on(tensors, device) -> torch.Tensor:
    """The groups' tensors summed on ``device`` (or on a tensor's device
    and group, as ``to_group`` takes it) in group order, out of
    place (on a repeated device a moved tensor is the group's own): the
    combine of the gather's reduce-scatter, of the PER statistics and of
    the replicas' gradients."""
    total = None
    for t in tensors:
        t = to_group(t, device)
        total = t if total is None else total + t
    return total


def check_on_group(device: torch.device, tree, name: str) -> None:
    """Host-side check that every tensor of ``tree`` sits on its group's
    ``device``: it passes trivially on a repeated device and catches a
    misplaced operand on a machine with several cards."""
    for t in tree_leaves(tree):
        if torch.is_tensor(t) and t.device != device:
            raise ValueError(f"{name} is on {t.device}, but its group "
                             f"runs on {device}")


_WINDOWS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def group_windows(rules: MeshRules, rows: int) -> List[torch.Tensor]:
    """Each group's first global ring slot ``g * rows`` as an int32 scalar
    on its device, made once (by a fill launch, which never waits for the
    device) and reused, so no kernel call copies a host scalar."""
    out = []
    for g, dev in enumerate(group_devices(rules)):
        key = (dev, g * rows)
        if key not in _WINDOWS:
            _WINDOWS[key] = torch.full((), g * rows, dtype=torch.int32,
                                       device=dev)
        out.append(_WINDOWS[key])
    return out
