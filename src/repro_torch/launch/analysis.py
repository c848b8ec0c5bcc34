"""The dry run's analysis: the card's roofline terms and the census of a
step's operations on the meta device.

Counterpart of ``repro/launch/analysis.py`` and of the HLO parsing it
re-exports (``repro/analysis/hlolint/hlo.py``). The reference reads the
compiled artifact's cost analysis and its collectives; the port has no
compiled artifact, so ``OpCensus`` watches the step run: a
``TorchDispatchMode`` that sees every aten operation (on the meta device
nothing is computed, only shapes), with ``torch.utils.flop_counter``'s
formulas for their FLOPs, each kernel's calls and work from its meta
route (``kernels.meta``, ``kernels.work``), the bytes ``to_group`` moves
between groups, the dtype of every output and the peak of live tensor
bytes (the counterpart of XLA's ``memory_analysis``: argument + temp +
output - alias).

The roofline of one card, NVIDIA H100 80GB HBM3 (700 W), from its data
sheet:

  compute term    = bf16 FLOPs / 989 TFLOP/s (dense, tensor cores)
                  + f32 FLOPs  / 67 TFLOP/s (outside the tensor cores)
  memory term     = bytes / 3.35 TB/s (HBM3)
  collective term = bytes moved between devices / 450 GB/s (NVLink, a
                    direction)
"""
from __future__ import annotations

import collections
import contextlib
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch._tree import tree_leaves
from repro_torch.distributed import sharding
from repro_torch.kernels import work as kwork

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s a direction
HBM_BYTES = 80e9                # the card's device memory
_PEAK = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}
# the caching allocator's unit: every block a multiple of 512 bytes
ALLOC_ROUND = 512


def bound_ms(w: kwork.Work) -> Tuple[float, str]:
    """The least time the card could take for a kernel's work: its bytes
    over the HBM rate or its FLOPs over the peak of their type, the
    larger. -> (ms, "bytes" or "operations")."""
    t_bytes = w.bytes / HBM_BW * 1e3
    t_ops = w.flops / _PEAK[w.flop_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: Optional[float]
    flops_f32_per_device: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: Optional[float] = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    peak_memory_per_device: float = 0.0
    notes: str = ""

    def finalize(self) -> "Roofline":
        """The three terms and the largest. ``flops_f32_per_device`` of
        the FLOPs run at the float32 peak, the rest at bf16's; a
        collective term of ``None`` (nothing measured) takes no part."""
        bf16 = self.flops_per_device - self.flops_f32_per_device
        self.compute_s = (bf16 / PEAK_FLOPS_BF16
                          + self.flops_f32_per_device / PEAK_FLOPS_F32)
        self.memory_s = self.bytes_per_device / HBM_BW
        self.collective_s = (None if self.collective_bytes_per_device is None
                             else self.collective_bytes_per_device
                             / NVLINK_BW)
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        self.bottleneck = max(terms, key=terms.get)
        total = self.flops_per_device * self.chips
        self.useful_ratio = self.model_flops / total if total else 0.0
        return self

    def to_dict(self) -> Dict:
        return asdict(self)


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (forward only), N the active parameters for
    MoE."""
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch           # decode: a token each


def backbone_flops(cfg, B: int, S: int) -> float:
    """Model FLOPs of one forward of a dense backbone at (B, S), no LM
    head: 2 a weight a token for the projections and the SwiGLU MLP, and
    4 d a visible (query, key) pair a head for the causal scores and the
    weighted sum."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    weights = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff
    pairs = kwork.visible_pairs(S, S)
    return cfg.num_layers * (2 * weights * B * S + 4 * B * H * hd * pairs)


# --------------------------------------------------------------------------- #
# the census
# --------------------------------------------------------------------------- #

# allocations that write nothing
_EMPTY = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(tree):
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Mode(TorchDispatchMode):
    def __init__(self, census: "OpCensus"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.census
        ins = _tensors((args, kwargs))
        c._sweep(ins)
        before = c._flop_total()
        out = func(*args, **kwargs)
        c._after(func, ins, _tensors(out), c._flop_total() - before)
        return out


class OpCensus:
    """Counts what a block of code does, op by op, while it runs under
    ``with OpCensus(args) as c:`` (on the meta device: nothing computes).

    - ``aten_flops``: ``FlopCounterMode``'s count (0 under
      ``flops=False``, which skips the formulas at half the cost; a
      kernel's wrapper is
      not an aten op: its plain version never runs here, and on the card
      its op has no formula); ``aten_flops_f32`` the share whose first
      operand is float32 (the CUDA cores' rate), the rest bf16's;
    - ``aten_bytes``: each op's tensor operands read and outputs written
      once (views and empty allocations move nothing);
    - ``kernels``: each kernel's calls (``LAUNCH_COUNTS``' unit), device
      launches, FLOPs by peak and bytes, from its meta route;
    - ``dtypes``: the outputs of each dtype;
    - the memory: ``argument_bytes`` (storages alive before the block:
      the ``args`` trees and every storage an op first meets as an
      operand), and ``peak_temp_bytes``, the most bytes of storages made
      in the block alive at once, each rounded up to the caching
      allocator's 512 bytes; a storage is freed when its last tensor
      dies (autograd's saved tensors keep theirs);
    - ``moves``: the bytes ``to_group`` moves between groups, keyed
      (source, destination), after ``watch(mesh)`` names the groups (the
      grid positions); a tensor's group is where it was placed or moved,
      or that of the first placed operand it was computed from, and an
      op's FLOPs and bytes count to that group too (``flops_by_group``,
      ``bytes_by_group``).
    """

    def __init__(self, args: Any = (), *, flops: bool = True):
        self.count_flops = flops
        self.aten_flops = 0
        self.aten_flops_f32 = 0
        self.aten_bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.dtypes: collections.Counter = collections.Counter()
        self.argument_bytes = 0
        self.temp_bytes = 0
        self.peak_temp_bytes = 0
        self.moves: collections.Counter = collections.Counter()
        self.move_count = 0
        self.unresolved_move_bytes = 0
        self.flops_by_group: collections.Counter = collections.Counter()
        self.bytes_by_group: collections.Counter = collections.Counter()
        self._args: Dict[int, StorageWeakRef] = {}
        self._temps: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self._tags = WeakIdKeyDictionary()
        self._positions: Dict[int, Tuple[int, int]] = {}
        self._flops: Optional[FlopCounterMode] = None
        self._stack: Optional[contextlib.ExitStack] = None
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._argument(t)

    # ----- entering and leaving -----------------------------------------
    def __enter__(self) -> "OpCensus":
        self._stack = contextlib.ExitStack()
        if self.count_flops:
            self._flops = self._stack.enter_context(FlopCounterMode(
                display=False))
        self._stack.enter_context(kwork.recording(self))
        self._stack.enter_context(sharding.moves(self._move))
        self._stack.enter_context(_Mode(self))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self._stack = None

    # ----- the results --------------------------------------------------
    @property
    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"]) for k, v in self.kernels.items()}

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(v["flops"] for v in
                                     self.kernels.values())

    @property
    def flops_f32(self) -> float:
        return self.aten_flops_f32 + sum(v["flops_f32"] for v in
                                         self.kernels.values())

    @property
    def bytes(self) -> float:
        return self.aten_bytes + sum(v["bytes"] for v in
                                     self.kernels.values())

    @property
    def peak_bytes(self) -> int:
        """Arguments plus the peak of the temporaries."""
        return self.argument_bytes + self.peak_temp_bytes

    def moved_bytes_per_device(self) -> Dict[str, int]:
        """The bytes each group received."""
        out: collections.Counter = collections.Counter()
        for (_, dst), n in self.moves.items():
            out[str(dst)] += n
        return dict(out)

    def summary(self) -> Dict[str, Any]:
        received = self.moved_bytes_per_device()
        return {"aten_flops": self.aten_flops,
                "aten_flops_f32": self.aten_flops_f32,
                "aten_bytes": self.aten_bytes, "aten_ops": self.ops,
                "kernels": self.kernels, "flops": self.flops,
                "bytes": self.bytes,
                "dtypes": {str(k): v for k, v in self.dtypes.items()},
                "argument_bytes": self.argument_bytes,
                "peak_temp_bytes": self.peak_temp_bytes,
                "peak_bytes": self.peak_bytes,
                "to_group_bytes": sum(self.moves.values()),
                "to_group_bytes_per_device": max(received.values(),
                                                 default=0),
                "unresolved_move_bytes": self.unresolved_move_bytes}

    # ----- the groups of a mesh -----------------------------------------
    def watch(self, mesh) -> None:
        """Name the groups of a ``sharding.Mesh``: each grid position by
        the device object the grid holds there (a grid may name one device
        several times)."""
        for a, row in enumerate(mesh.grid):
            for b, dev in enumerate(row):
                self._positions[id(dev)] = (a, b)

    @contextlib.contextmanager
    def placing(self):
        """Set-up moves: ``to_group`` in the block puts each moved tensor
        in its destination's group, and nothing is counted."""
        with sharding.moves(self._move):
            yield
        self.moves.clear()
        self.move_count = self.unresolved_move_bytes = 0

    def place(self, tree, position: Tuple[int, int]) -> None:
        """Put the tensors of ``tree`` in group ``position``."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._tags[t] = position

    def _move(self, leaf, dest, out):
        if not isinstance(leaf, torch.Tensor):
            return out
        src = self._tags.get(leaf)
        dst = (self._tags.get(dest) if isinstance(dest, torch.Tensor)
               else self._positions.get(id(dest)))
        nbytes = leaf.numel() * leaf.element_size()
        if src is None or dst is None:
            self.unresolved_move_bytes += nbytes
        elif src != dst:
            self.moves[(src, dst)] += nbytes
            self.move_count += 1
        if dst is not None and dst != src:
            if out is leaf:                 # a repeated device: an alias
                out = leaf.view_as(leaf)
            self._tags[out] = dst
        return out

    # ----- the op hooks -------------------------------------------------
    def kernel(self, name: str, w: kwork.Work) -> None:
        """A kernel's meta route reports one wrapper call."""
        k = self.kernels.setdefault(name, {"calls": 0, "launches": 0,
                                           "flops": 0, "flops_f32": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["launches"] += w.launches
        k["flops"] += w.flops
        k["flops_f32"] += w.flops if w.flop_type == "f32" else 0
        k["bytes"] += w.bytes

    def _flop_total(self) -> int:
        if not self.count_flops:
            return 0
        return sum(self._flops.flop_counts["Global"].values())

    def _alive(self, key: int) -> bool:
        """Whether ``key`` names a live storage the census knows; a dead
        one's entry goes (its address may come again), a temporary's
        bytes with it."""
        if key in self._temps:
            if not self._temps[key][0].expired():
                return True
            self.temp_bytes -= self._temps.pop(key)[1]
        if key in self._args:
            if not self._args[key].expired():
                return True
            del self._args[key]
        return False

    def _argument(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if not self._alive(key):
            self._args[key] = StorageWeakRef(t.untyped_storage())
            self.argument_bytes += _rounded(t.untyped_storage().nbytes())

    def _sweep(self, ins) -> None:
        """Take an operand never seen before as an argument."""
        for t in ins:
            self._argument(t)

    def _free_dead(self) -> None:
        """Drop every temporary whose last tensor died. ``temp_bytes``
        counts dead ones until then, so it never reads low: the census
        frees only where a new peak could start."""
        for k in [k for k, (ref, _) in self._temps.items() if ref.expired()]:
            self.temp_bytes -= self._temps.pop(k)[1]

    def _after(self, func, ins, outs, flops: int) -> None:
        self.ops += 1
        if flops:
            self.aten_flops += flops
            floats = [t for t in ins if t.is_floating_point()]
            if floats and floats[0].dtype == torch.float32:
                self.aten_flops_f32 += flops
        moved = 0
        if not func.is_view and func not in _EMPTY:
            moved = sum(t.numel() * t.element_size() for t in ins + outs)
            self.aten_bytes += moved
        new = {}
        for t in outs:
            self.dtypes[t.dtype] += 1
            key = _storage_key(t)
            if key not in new and not self._alive(key):
                new[key] = t.untyped_storage()
        if new:
            added = sum(_rounded(st.nbytes()) for st in new.values())
            if self.temp_bytes + added > self.peak_temp_bytes:
                self._free_dead()
            for key, st in new.items():
                n = _rounded(st.nbytes())
                self._temps[key] = (StorageWeakRef(st), n)
                self.temp_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes,
                                       self.temp_bytes)
        if len(self._tags):
            tag = next((self._tags[t] for t in ins if t in self._tags), None)
            if tag is not None:
                self.flops_by_group[tag] += flops
                self.bytes_by_group[tag] += moved
                for t in outs:
                    self._tags.setdefault(t, tag)
