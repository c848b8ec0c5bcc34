"""Public kernel ops: the counterpart of ``repro/kernels/ops.py``'s
replay ops (``ring_write`` and ``ring_write_fields`` / ``ring_gather``
and ``ring_gather_fields`` / ``per_topk`` / ``priority_scatter``), the
bench baselines
(``per_scores`` / ``ring_write_rowloop`` / ``ring_gather_rowloop``) and
model ops (``rmsnorm`` / ``rope`` / ``flash_attention`` /
``decode_attention`` / ``ssd_scan``), and the mesh forms of the replay ops
(``ring_write_fields_sharded`` / ``ring_gather_fields_sharded`` /
``per_scores_sharded`` / ``per_topk_sharded`` /
``priority_scatter_sharded``, and the one-field ``ring_write_sharded`` /
``ring_gather_sharded``), the counterparts of ``repro/kernels/ops.py``'s
``shard_map`` wrappers.

Which version runs is decided by the operand's device, never by what the
machine has (``kernels.pick``): a CUDA tensor goes to the hand-written
kernel (which raises on anything it does not take), a CPU tensor to the
plain PyTorch version, a meta tensor to its shape-and-work route
(``kernels.meta``: empty outputs, the call and its work told to the
census of ``launch.analysis``), and a tensor on any other device is
refused. There is no switch and no fallback between them: where the
reference chose between its jnp path and its Pallas kernels with
``use_pallas``, the port's model code always calls these.

Gradients: where an operand needs one (grad mode on and an operand that
requires grad), ``rmsnorm``, ``rope``, ``flash_attention`` and
``ssd_scan`` go through their ``autograd.Function``s (``_rms.RMSNorm``,
``_rope.Rope``, ``_fa.FlashAttention``, ``_ssd.SSDScan``), whose
backward is a kernel too on the card; elsewhere (serving) they call the
forward alone, flash writes no LSE and the scan hands back no chunk
states.
``decode_attention`` has no backward (no training path runs it), so it
refuses such a call with a ``ValueError`` on every device: the CPU
trains no path the card cannot.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import trace
from repro_torch.analysis.hlolint.contract import (MOVE, CollectiveContract,
                                                   CollectiveRule,
                                                   EntrypointContract)
from repro_torch.distributed.sharding import (MeshRules, check_on_group,
                                              group_devices, group_windows,
                                              sum_on, to_group)
from repro_torch.kernels import pick
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import replay_ops as _replay
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import rope as _rope
from repro_torch.kernels import ssd_scan as _ssd


@trace.spanned("op.ring_write")
def ring_write(data: torch.Tensor, batch: torch.Tensor, ptr: torch.Tensor,
               **kw) -> torch.Tensor:
    """In-place ring write of (n, ...) rows at ``(ptr + i) % capacity``."""
    return pick(data, _replay.ring_write_ref, _replay.ring_write,
                "ring_write")(data, batch, ptr, **kw)


@trace.spanned("op.ring_write")
def ring_write_fields(datas: Sequence[torch.Tensor],
                      batches: Sequence[torch.Tensor], ptr: torch.Tensor,
                      **kw):
    """In-place ring write of several fields' (n, ...) rows at the same
    slots ``(ptr + i) % capacity``: one kernel launch for all of them."""
    return pick(datas[0], _replay.ring_write_fields_ref,
                _replay.ring_write_fields, "ring_write_fields")(
                    datas, batches, ptr, **kw)


@trace.spanned("op.ring_gather")
def ring_gather(data: torch.Tensor, idx: torch.Tensor, **kw
                ) -> torch.Tensor:
    """Batched random row gather from the replay ring."""
    return pick(data, _replay.ring_gather_ref, _replay.ring_gather,
                "ring_gather")(data, idx, **kw)


@trace.spanned("op.ring_gather")
def ring_gather_fields(datas: Sequence[torch.Tensor], idx: torch.Tensor,
                       **kw):
    """Batched random row gather of several fields at the same indices:
    one kernel launch for all of them."""
    return pick(datas[0], _replay.ring_gather_fields_ref,
                _replay.ring_gather_fields, "ring_gather_fields")(
                    datas, idx, **kw)


@trace.spanned("op.per_topk")
def per_topk(priorities: torch.Tensor, gumbel: torch.Tensor, alpha: float,
             k: int, **kw):
    """Fused PER Gumbel score + top-k -> (scores desc, global idx)."""
    return pick(priorities, _replay.per_topk_ref, _replay.per_topk,
                "per_topk")(priorities, gumbel, alpha, k, **kw)


@trace.spanned("op.priority_scatter")
def priority_scatter(priorities: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor, **kw) -> torch.Tensor:
    """In-place ``priorities[idx] = values``, the last draw winning."""
    return pick(priorities, _replay.priority_scatter_ref,
                _replay.priority_scatter, "priority_scatter")(
                    priorities, idx, values, **kw)


@trace.spanned("op.per_scores")
def per_scores(priorities: torch.Tensor, gumbel: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """Gumbel-top-k scores of every row of the priority vector."""
    return pick(priorities, _replay.per_scores_ref, _replay.per_scores,
                "per_scores")(priorities, gumbel, alpha)


@trace.spanned("op.ring_write_rowloop")
def ring_write_rowloop(data: torch.Tensor, batch: torch.Tensor,
                       ptr: torch.Tensor) -> torch.Tensor:
    """The row-at-a-time in-place ring write (no window)."""
    return pick(data, _replay.ring_write_ref, _replay.ring_write_rowloop,
                "ring_write_rowloop")(data, batch, ptr)


@trace.spanned("op.ring_gather_rowloop")
def ring_gather_rowloop(data: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """The row-at-a-time gather (no window, indices wrapped and clamped)."""
    return pick(data, _replay.ring_gather_rowloop_ref,
                _replay.ring_gather_rowloop, "ring_gather_rowloop")(data, idx)


def _needs_grad(*operands: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands)


def _refuse_grad(name: str, *operands: torch.Tensor) -> None:
    """The refusal of a gradient through a kernel with no backward."""
    if _needs_grad(*operands):
        raise ValueError(
            f"{name} has no backward kernel: a gradient through it would "
            "not train on the card (call it under torch.no_grad() or with "
            "operands that do not require grad)")


@trace.spanned("op.rmsnorm")
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """Row-wise RMSNorm of (..., D) in float32, cast back to x's dtype."""
    if _needs_grad(x, weight):
        return _rms.RMSNorm.apply(x, weight, eps)
    return pick(x, _rms.rmsnorm_ref, _rms.rmsnorm, "rmsnorm")(x, weight,
                                                              eps=eps)


# hlolint: entrypoint[rope]
@trace.spanned("op.rope")
def rope(q: torch.Tensor, k: Optional[torch.Tensor], pos_q: torch.Tensor,
         pos_k: Optional[torch.Tensor], theta: float
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rotary embedding of a layer's q (B,Sq,H,d) at ``pos_q`` (Sq,) and k
    (B,Sk,KV,d) at ``pos_k`` (Sk,) -> (q', k'); without k (decode's
    cross attention) k' is None. One launch for both."""
    operands = (q,) if k is None else (q, k)
    if _needs_grad(*operands):
        return _rope.Rope.apply(q, k, pos_q, pos_k, theta)
    return pick(q, _rope.rope_ref, _rope.rope, "rope")(q, k, pos_q, pos_k,
                                                       theta)


@trace.spanned("op.flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """(B,Sq,H,d) x (B,Sk,KV,d)^2 -> (B,Sq,H,d)."""
    if _needs_grad(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, causal, window, prefix_len)
    return pick(q, _fa.attention_ref, _fa.flash_attention,
                "flash_attention")(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)


@trace.spanned("op.decode_attention")
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """(B,H,d) x (B,S,KV,d)^2 -> (B,H,d); ``valid_len`` a scalar tensor.
    Refuses a call that needs a gradient (no backward kernel: no
    training path runs it)."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    return pick(q, _dec.decode_attention_ref, _dec.decode_attention,
                "decode_attention")(q, k_cache, v_cache, valid_len)


@trace.spanned("op.ssd_scan")
def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD scan: (B,S,H,P), (B,S,H), (B,S,H,N)^2 ->
    (y (B,S,H,P), final_state (B,H,P,N)); chunks of min(chunk, S), from
    ``initial_state`` (B,H,P,N) or zero."""
    operands = (x, dtA, B_, C_) + (() if initial_state is None
                                   else (initial_state,))
    if _needs_grad(*operands):
        return _ssd.SSDScan.apply(x, dtA, B_, C_, initial_state, chunk)
    return pick(x, _ssd.ssd_scan_ref, _ssd.ssd_scan, "ssd_scan")(
        x, dtA, B_, C_, chunk=chunk, initial_state=initial_state)


# --------------------------------------------------------------------------- #
# the mesh: each batch group runs the replay ops above on its ring shard
# --------------------------------------------------------------------------- #
#
# A sharded pool is a list of G shards, shard g holding global ring slots
# [g * rows, (g + 1) * rows) on batch group g's device (``sharding.
# group_devices``). Each group's op goes through the device dispatch
# above (the kernel for a CUDA shard, the plain version for a CPU one)
# with the group's window start, so every op launches once a group. The
# one-card stand-in names one device for several groups: a ``to_group``
# onto the same device returns the very tensor, so every combine writes
# into fresh outputs.

# hlolint move budgets: what each sharded op moves between groups, declared
# next to the ops that move it (dims over the probe's symbols: capacity,
# batch, groups, k, rows). The megastep contracts in core/pipeline.py
# compose them; none is as large as the replay capacity.
RING_WRITE_MOVES = (
    # every group receives the round's whole rows
    CollectiveRule(MOVE, ("rows", "...")),
)
RING_GATHER_MOVES = (
    # the (batch,) indices to every group, then each group's
    # (batch//groups) slice of every other group's partial gather
    CollectiveRule(MOVE, ("batch",)),
    CollectiveRule(MOVE, ("batch//groups", "...")),
)
PER_TOPK_MOVES = (
    # each group's slice of the (capacity,) Gumbel field, then its k
    # candidates (scores, indices) to the first group's device
    CollectiveRule(MOVE, ("capacity//groups",)),
    CollectiveRule(MOVE, ("k",)),
)

HLOLINT_CONTRACTS = (
    # a layer's rotary embedding: q and k in one launch, no host read, the
    # float32 math kept inside the kernel (its plain version's float32
    # passes on the CPU)
    EntrypointContract(
        name="rope", module=__name__,
        float_dtypes=("float32", "bfloat16"), launches={"rope": "1"}),
    EntrypointContract(
        name="per_topk_sharded", module=__name__,
        collectives=CollectiveContract(allow=PER_TOPK_MOVES,
                                       max_elems="capacity"),
        launches={"per_topk": "groups"}),
    EntrypointContract(
        name="ring_gather_sharded", module=__name__,
        collectives=CollectiveContract(allow=RING_GATHER_MOVES,
                                       max_elems="capacity"),
        launches={"ring_gather": "groups"}),
)


def _group_devices_of(rules: MeshRules, shards, name: str):
    """The groups' devices, each group's operands checked against its
    own."""
    devs = group_devices(rules)
    if len(shards) != len(devs):
        raise ValueError(f"{name}: {len(shards)} shards for {len(devs)} "
                         f"batch groups")
    for g, (dev, shard) in enumerate(zip(devs, shards)):
        check_on_group(dev, shard, f"{name}: shard {g}")
    return devs


def ring_write_fields_sharded(shards: Sequence[Sequence[torch.Tensor]],
                              batches: Sequence[torch.Tensor],
                              ptr: torch.Tensor, rules: MeshRules, *,
                              capacity: Optional[int] = None):
    """Mesh ring write, in place: every group receives the whole round's
    rows and writes, with one ``ring_write_fields`` launch for all of its
    fields, the rows whose slot ``(ptr + i) % capacity`` falls in its
    window. ``shards[g]`` holds group g's fields; ``capacity`` defaults
    to the shards' rows times the groups. Returns ``shards``."""
    devs = _group_devices_of(rules, shards, "ring_write_fields_sharded")
    rows = shards[0][0].shape[0]
    cap = rows * len(devs) if capacity is None else capacity
    for fields, dev, lo in zip(shards, devs, group_windows(rules, rows)):
        ring_write_fields(fields, to_group(list(batches), dev),
                          to_group(ptr, dev), capacity=cap, window_start=lo)
    return shards


def ring_write_sharded(data: Sequence[torch.Tensor], batch: torch.Tensor,
                       ptr: torch.Tensor, rules: MeshRules, *,
                       capacity: Optional[int] = None):
    """One-field ``ring_write_fields_sharded``: ``data`` is the list of a
    pool's G shards."""
    ring_write_fields_sharded([[d] for d in data], [batch], ptr, rules,
                              capacity=capacity)
    return data


def ring_gather_fields_sharded(shards: Sequence[Sequence[torch.Tensor]],
                               idx: torch.Tensor, rules: MeshRules
                               ) -> List[List[torch.Tensor]]:
    """Mesh gather of B global indices: each group gathers all of them
    from its shard with one ``ring_gather_fields`` launch (zeros outside
    its window), then the reduce-scatter: group g's output is the sum,
    over the groups h in order, of h's partial at rows ``[g * B/G, (g +
    1) * B/G)``, on g's device. One term of each sum is nonzero, so the
    rows equal the single-device gather's (a stored -0.0 may come back
    as +0.0). Returns ``outs[g][f]``, group g's rows of field f."""
    devs = _group_devices_of(rules, shards, "ring_gather_fields_sharded")
    G, B = len(devs), idx.shape[0]
    if B % G:
        raise ValueError(f"a gather of {B} rows does not split over {G} "
                         f"batch groups")
    rows, b = shards[0][0].shape[0], B // G
    parts = [ring_gather_fields(fields, to_group(idx, dev), window_start=lo)
             for fields, dev, lo in zip(shards, devs,
                                        group_windows(rules, rows))]
    return [[sum_on([part[f].narrow(0, g * b, b) for part in parts], dev)
             for f in range(len(parts[0]))] for g, dev in enumerate(devs)]


# hlolint: entrypoint[ring_gather_sharded]
def ring_gather_sharded(data: Sequence[torch.Tensor], idx: torch.Tensor,
                        rules: MeshRules) -> List[torch.Tensor]:
    """One-field ``ring_gather_fields_sharded``: group g's rows, one
    tensor a group."""
    return [out[0] for out in ring_gather_fields_sharded(
        [[d] for d in data], idx, rules)]


def _gumbel_slice(gumbel: torch.Tensor, g: int, rows: int, dev):
    """Group g's slice of the one (capacity,) Gumbel field, never a new
    draw."""
    return to_group(gumbel.narrow(0, g * rows, rows), dev)


def per_scores_sharded(priorities: Sequence[torch.Tensor],
                       gumbel: torch.Tensor, alpha: float,
                       rules: MeshRules) -> List[torch.Tensor]:
    """Mesh PER scores: elementwise, so each group scores its priority
    shard against its slice of the (capacity,) Gumbel field, one launch
    a group. Returns each group's scores on its device."""
    devs = _group_devices_of(rules, [[p] for p in priorities],
                             "per_scores_sharded")
    rows = priorities[0].shape[0]
    return [per_scores(p, _gumbel_slice(gumbel, g, rows, dev), alpha)
            for g, (p, dev) in enumerate(zip(priorities, devs))]


# hlolint: entrypoint[per_topk_sharded]
def per_topk_sharded(priorities: Sequence[torch.Tensor],
                     gumbel: torch.Tensor, alpha: float, k: int,
                     rules: MeshRules):
    """Mesh two-phase PER selection: each group runs ``per_topk`` on its
    priority shard and its slice of the Gumbel field, with its window
    start (one launch a group), and emits k candidates ``(score,
    global_idx)``; the ``(G * k,)`` candidates are concatenated in
    row-major group order on the first group's device
    (``sharding.ALLGATHER_CANDIDATE_CONTRACT``) and
    ``merge_topk_candidates`` picks k. The result equals the
    single-device ``per_topk``: the scores bit for bit, the indices on
    every finite slot. Requires ``k <= rows`` of a shard."""
    devs = _group_devices_of(rules, [[p] for p in priorities],
                             "per_topk_sharded")
    rows, home = priorities[0].shape[0], devs[0]
    cand = [per_topk(p, _gumbel_slice(gumbel, g, rows, dev), alpha, k,
                     window_start=lo)
            for g, (p, dev, lo) in enumerate(zip(
                priorities, devs, group_windows(rules, rows)))]
    return _replay.merge_topk_candidates(
        torch.cat([to_group(s, home) for s, _ in cand]),
        torch.cat([to_group(i, home) for _, i in cand]), k)


def priority_scatter_sharded(priorities: Sequence[torch.Tensor],
                             idx: torch.Tensor, values: torch.Tensor,
                             rules: MeshRules):
    """Mesh re-prioritisation, in place: every group applies the
    in-window subset of the (B,) updates to its own shard, one launch a
    group (the last draw of a repeated row wins, as on one device).
    Returns ``priorities``."""
    devs = _group_devices_of(rules, [[p] for p in priorities],
                             "priority_scatter_sharded")
    rows = priorities[0].shape[0]
    for p, dev, lo in zip(priorities, devs, group_windows(rules, rows)):
        priority_scatter(p, to_group(idx, dev), to_group(values, dev),
                         window_start=lo)
    return priorities
