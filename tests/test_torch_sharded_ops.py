"""The port's sharded replay wrappers (``kernels/ops.py``) against the
reference's own two-phase identity on one device: each window's op from
``repro.kernels.replay_ops`` with its ``window_start`` (the write and the
gather through their jnp ``*_ref``s, the scatter, whose repeated indices
the ``_ref`` leaves unspecified, and the top-k through the Pallas kernels
in interpret mode), the gather's partials summed and split by rows as
``psum_scatter`` does, and the windows' top-k candidates merged with
``merge_topk_candidates``. The port runs on a mesh that names the CPU G
times; the two must agree bit for bit, with ties and empty slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t

from repro.kernels import replay_ops as jrops
from repro_torch.distributed.sharding import (ALLGATHER_CANDIDATE_CONTRACT,
                                              group_devices, trainer_rules)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops
from repro_torch.launch.mesh import make_ac_mesh

torch.set_num_threads(2)

CAP, ROWS_IN, B, W = 256, 40, 32, 3
ALPHA = 0.6
GROUPS = (2, 4, 8)


# the reference's window ops, jitted once with the window start traced, so
# the G windows of a test share one compile
_write = jax.jit(lambda d, r, p, lo: jrops.ring_write_ref(
    d, r, p, capacity=CAP, window_start=lo))
_gather = jax.jit(lambda d, i, lo: jrops.ring_gather_ref(
    d, i, window_start=lo))
_scatter = jax.jit(lambda p, i, v, lo: jrops.priority_scatter(
    p, i, v, window_start=lo))
_topk = jax.jit(lambda p, g, lo: jrops.per_topk(p, g, ALPHA, B,
                                                window_start=lo, block=128))


def _rules(groups):
    """A dp mesh of ``groups`` devices: (2, groups / 2), the CPU named
    once a device, so the groups run row-major over both axes."""
    return trainer_rules(make_ac_mesh(2, groups // 2,
                                      devices=["cpu"] * groups), "dp")


def _split(x, groups):
    rows = x.shape[0] // groups
    return [x[g * rows:(g + 1) * rows].clone() for g in range(groups)]


def _pool(seed):
    """Priorities drawn from a few values (ties), a third of the slots
    empty, and a Gumbel field with repeated values (score ties)."""
    rng = np.random.default_rng(seed)
    pri = rng.choice(np.float32([0.25, 0.5, 1.0]), CAP)
    pri[rng.random(CAP) < 1 / 3] = 0.0
    gum = np.round(rng.gumbel(size=CAP), 1).astype(np.float32)
    return pri, gum


def test_groups_follow_the_candidate_contract():
    """The groups run row-major over ``batch_axes``: under dp over both
    axes, under ac over the batch column of ac row 0."""
    devs = [torch.device("cuda", i) for i in range(8)]
    mesh = make_ac_mesh(2, 4, devices=devs)
    assert ALLGATHER_CANDIDATE_CONTRACT["order"] == "row-major"
    assert group_devices(trainer_rules(mesh, "dp")) == devs
    assert group_devices(trainer_rules(mesh, "ac")) == devs[:4]


@pytest.mark.parametrize("groups", GROUPS)
def test_ring_write_sharded_equals_the_window_writes(groups):
    """A write that wraps at the ring's end: each window keeps its rows."""
    rng = np.random.default_rng(groups)
    data = rng.standard_normal((CAP, W)).astype(np.float32)
    rows = rng.standard_normal((ROWS_IN, W)).astype(np.float32)
    ptr = CAP - ROWS_IN // 2
    rows_local = CAP // groups
    want = np.concatenate([np.asarray(_write(
        jnp.asarray(data[lo:lo + rows_local]), jnp.asarray(rows), ptr, lo))
        for lo in range(0, CAP, rows_local)])
    shards = _split(t(data), groups)
    kops.ring_write_sharded(shards, t(rows), t(np.int32(ptr), torch.int32),
                            _rules(groups))
    assert torch.equal(torch.cat(shards), t(want))


@pytest.mark.parametrize("groups", GROUPS)
def test_ring_gather_sharded_equals_the_summed_windows(groups):
    """Each window's gather (zeros outside it), the partials summed and
    group g given rows [g B/G, (g + 1) B/G), as ``psum_scatter`` does;
    repeated indices included."""
    rng = np.random.default_rng(10 + groups)
    data = rng.standard_normal((CAP, W)).astype(np.float32)
    idx = rng.integers(0, CAP, B).astype(np.int32)
    idx[:4] = idx[4]
    rows_local, b = CAP // groups, B // groups
    total = sum(np.asarray(_gather(jnp.asarray(data[lo:lo + rows_local]),
                                   jnp.asarray(idx), lo))
                for lo in range(0, CAP, rows_local))
    got = kops.ring_gather_sharded(_split(t(data), groups),
                                   t(idx, torch.int32), _rules(groups))
    assert len(got) == groups
    for g, rows in enumerate(got):
        assert torch.equal(rows, t(total[g * b:(g + 1) * b]))
    assert torch.equal(torch.cat(got), t(data[idx]))


@pytest.mark.parametrize("groups", GROUPS)
def test_priority_scatter_sharded_equals_the_window_scatters(groups):
    """Repeated indices: the last draw wins in every window."""
    pri, _ = _pool(20 + groups)
    rng = np.random.default_rng(groups)
    idx = rng.integers(0, CAP, B).astype(np.int32)
    idx[B // 2:] = idx[:B // 2]
    vals = rng.random(B).astype(np.float32)
    rows_local = CAP // groups
    want = np.concatenate([np.asarray(_scatter(
        jnp.asarray(pri[lo:lo + rows_local]), jnp.asarray(idx),
        jnp.asarray(vals), lo)) for lo in range(0, CAP, rows_local)])
    shards = _split(t(pri), groups)
    kops.priority_scatter_sharded(shards, t(idx, torch.int32), t(vals),
                                  _rules(groups))
    assert torch.equal(torch.cat(shards), t(want))


@pytest.mark.parametrize("groups", GROUPS)
def test_per_topk_sharded_equals_the_window_merge(groups):
    """Each window's top-k with its window offset, the candidates merged
    in window order: the scores bit for bit, the indices on the finite
    slots and the sentinel on the ``-inf`` ones; and the same selection
    as the dense top-k. k = 32 exceeds the live rows of some windows at
    G = 8."""
    pri, gum = _pool(30 + groups)
    rows_local = CAP // groups
    cand = [_topk(jnp.asarray(pri[lo:lo + rows_local]),
                  jnp.asarray(gum[lo:lo + rows_local]), lo)
            for lo in range(0, CAP, rows_local)]
    want_v, want_i = jrops.merge_topk_candidates(
        jnp.concatenate([c[0] for c in cand]),
        jnp.concatenate([c[1] for c in cand]), B)
    v, i = kops.per_topk_sharded(_split(t(pri), groups), t(gum), ALPHA, B,
                                 _rules(groups))
    assert torch.equal(v, t(want_v))
    fin = np.isfinite(np.asarray(want_v))
    np.testing.assert_array_equal(n(i)[fin], np.asarray(want_i)[fin])
    assert (n(i)[~fin] == rops.IDX_SENTINEL).all()
    dense_v, dense_i = rops.per_topk_ref(t(pri), t(gum), ALPHA, B)
    assert torch.equal(v, dense_v) and torch.equal(i, dense_i)


@pytest.mark.parametrize("groups", GROUPS)
def test_per_scores_sharded_equals_the_scores(groups):
    """Elementwise: each group's slice of the one Gumbel field."""
    pri, gum = _pool(40 + groups)
    got = kops.per_scores_sharded(_split(t(pri), groups), t(gum), ALPHA,
                                  _rules(groups))
    want = np.asarray(jrops.per_scores(jnp.asarray(pri), jnp.asarray(gum),
                                       ALPHA))
    assert len(got) == groups
    assert torch.equal(torch.cat(got), t(want))


def test_a_shard_on_another_device_is_refused():
    """The group wrappers check each operand's device against its
    group's: a shard on the ``meta`` device of a CPU mesh is refused."""
    shards = _split(torch.zeros(CAP, W), 2)
    shards[1] = torch.empty((CAP // 2, W), device="meta")
    with pytest.raises(ValueError, match="shard 1 is on meta"):
        kops.ring_gather_sharded(shards, torch.zeros(B, dtype=torch.int32),
                                 _rules(2))


def test_a_gather_that_does_not_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        kops.ring_gather_sharded(_split(torch.zeros(CAP, W), 4),
                                 torch.zeros(30, dtype=torch.int32),
                                 _rules(4))
