"""The multi-device megastep (``core/model_parallel.py``) on a mesh that
names the CPU once a device, against the JAX package's single-device
trainer at ``tests/sharded_check.py``'s config, through ``JaxDraws``.

The reference's own mesh path does not run on this tree's JAX, so, as in
``tests/sharded_check.py`` (which holds the reference's sharded megastep
to its single-device one), the port's mesh trainer is held to the
single-device JAX trainer: the ring's cursor, the draws' key and the
first PER update's draw exactly, the parameters and the critic loss
within ``rtol 1e-3, atol 1e-5``. Then the refusals of a mesh config,
resume on a mesh, and ``auto_tune`` over a mesh."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import assert_tree_close, assert_tree_equal, n, to_np
from test_torch_pipeline import JaxDraws

import repro  # noqa: F401  (jax_threefry_partitionable, as in the trainer)
from repro.core import SpreezeConfig as JaxConfig
from repro.core import SpreezeTrainer as JaxTrainer
from repro.kernels import replay_ops as jrops
from repro_torch import interop
from repro_torch._tree import tree_leaves
from repro_torch.core import SpreezeConfig, SpreezeTrainer, faults
from repro_torch.core import adaptation
from repro_torch.core import model_parallel as mp
from repro_torch.launch.mesh import make_ac_mesh
from repro_torch.replay import prioritized as per
from repro_torch.rl import AlgoHP
from repro_torch.rl.networks import PlacedEnsemble
from repro_torch.train import checkpoint
from repro_torch.train import resume as resume_lib

torch.set_num_threads(2)

# tests/sharded_check.py's _cfg
CFG = dict(env_name="pendulum", num_envs=2, batch_size=32, chunk_len=4,
           updates_per_round=2, warmup_frames=32, replay_capacity=256,
           eval_every_rounds=10**9, seed=3, rounds_per_dispatch=2)
MEGASTEPS = 2
# the tolerance tests/sharded_check.py holds the reference's sharded
# megastep to against its single-device one
RTOL, ATOL = 1e-3, 1e-5

# (algo, prioritized, placement, mesh shape): the satellite's five
ARMS = {"sac-ac-2x4": ("sac", False, "ac", (2, 4)),
        "sac-per-ac-2x2": ("sac", True, "ac", (2, 2)),
        "sac-dp-2x4": ("sac", False, "dp", (2, 4)),
        "td3-dp-2x2": ("td3", False, "dp", (2, 2)),
        "ddpg-per-dp-2x2": ("ddpg", True, "dp", (2, 2))}


def cpu_mesh(ac, batch):
    return make_ac_mesh(ac, batch, devices=["cpu"] * (ac * batch))


@functools.lru_cache(maxsize=None)
def _jax_run(algo, prioritized):
    """The JAX single-device trainer: its start state (numpy) and key
    schedule, then ``_warmup`` and two megasteps; the end state as
    numpy and the last megastep's metrics."""
    jtr = JaxTrainer(JaxConfig(algo=algo, prioritized=prioritized, **CFG))
    start = (to_np(jtr.state), to_np(jtr.replay), to_np(jtr.env_states),
             (jtr.key, jtr._eval_key, jtr._viz_key))
    jtr._warmup()
    for _ in range(MEGASTEPS):
        (jtr.state, jtr.replay, jtr.env_states, jtr.key,
         metrics) = jtr._megastep(jtr.state, jtr.replay, jtr.env_states,
                                  jtr.key)
    end = (to_np(jtr.state), to_np(jtr.replay), np.asarray(jtr.key),
           np.asarray(metrics["critic_loss"]))
    return start, end


def _mesh_port(algo, prioritized, placement, shape, **kw):
    """The port's mesh trainer from the JAX trainer's start state, with
    its draws."""
    (state, replay, env_states, (key, ekey, vkey)), _ = _jax_run(
        algo, prioritized)
    cfg = SpreezeConfig(algo=algo, prioritized=prioritized,
                        mesh=cpu_mesh(*shape), placement=placement,
                        device="cpu", **CFG, **kw)
    tr = SpreezeTrainer(cfg, draws=JaxDraws(key, "pendulum", ekey, vkey))
    tr.state = mp.place_state(interop.algo_state_from_numpy(state, "cpu"),
                              tr.layout)
    whole = (interop.prioritized_from_numpy(replay, "cpu") if prioritized
             else interop.replay_from_numpy(replay, "cpu"))
    tr.replay = mp.place_replay(whole, tr.layout)
    tr.env_states = interop.to_tensors(env_states, "cpu")
    return tr


def _record_first_draw(monkeypatch):
    """Wraps ``per.sample``: the first call's whole priorities, Gumbel
    field and drawn indices."""
    seen, sample = [], per.sample

    def recording(state, gumbel, batch_size, **kw):
        out = sample(state, gumbel, batch_size, **kw)
        if not seen:
            pri = state.priorities
            seen.append((torch.cat(pri) if isinstance(pri, list) else pri,
                         gumbel, out[1]))
        return out

    monkeypatch.setattr(per, "sample", recording)
    return seen


@pytest.mark.parametrize("arm", list(ARMS))
def test_mesh_megastep_matches_the_single_device_jax_trainer(monkeypatch,
                                                             arm):
    """``_warmup`` and two megasteps (R 2, K 2) on the mesh from the JAX
    trainer's start state with its draws, against the JAX trainer's; the
    replicas end bitwise equal and the ``overlap_eval`` snapshot is the
    actor."""
    algo, prioritized, placement, shape = ARMS[arm]
    seen = _record_first_draw(monkeypatch)
    tr = _mesh_port(algo, prioritized, placement, shape, overlap_eval=True)
    groups = shape[1] if placement == "ac" else shape[0] * shape[1]
    assert tr.layout.groups == groups
    assert all(len(s) == groups for s in tr.replay.base.data.values()) \
        if prioritized else all(len(s) == groups
                                for s in tr.replay.data.values())
    # under ac each group's Q stack is split over the ac rows
    q0 = tr.state.replicas[0].q
    assert isinstance(q0, PlacedEnsemble) == (placement == "ac")
    tr._warmup()
    for _ in range(MEGASTEPS):
        metrics = tr.megastep()

    _, (want_s, want_r, want_key, want_closs) = _jax_run(algo, prioritized)
    assert_tree_equal(want_key, np.asarray(tr.draws.key))
    got_r = mp.whole_replay(tr)
    if prioritized:
        got_r = interop.prioritized_to_numpy(got_r)
        np.testing.assert_allclose(got_r["priorities"], want_r.priorities,
                                   RTOL, ATOL)
        want_r, got_r = want_r.base, got_r["base"]
    else:
        got_r = interop.replay_to_numpy(got_r)
    assert_tree_equal((want_r.ptr, want_r.size), (got_r["ptr"],
                                                  got_r["size"]))
    assert_tree_close(want_r.data, got_r["data"], RTOL, ATOL)
    got_s = interop.algo_state_to_numpy(mp.whole_state(tr))
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want_s, name), got_s[name], RTOL, ATOL)
    np.testing.assert_array_equal(want_s.step, got_s["step"])
    np.testing.assert_allclose(n(metrics["critic_loss"]), want_closs,
                               RTOL, ATOL)
    # the replicas stay bitwise equal, and the overlap_eval snapshot is
    # the actor
    for rep in tr.state.replicas[1:]:
        assert_tree_equal(interop.algo_state_to_numpy(
            mp.gather_state(mp.PlacedState((rep,)), tr.layout)),
            got_s)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(metrics["actor_snapshot"].params),
        tree_leaves(tr.state.actor)))
    if prioritized:
        # the first update: every written row still at the max priority,
        # so the reference's dense draw over the same pool and field
        pri, gumbel, idx = seen[0]
        want = jrops.per_topk_ref(jnp.asarray(n(pri)), jnp.asarray(
            n(gumbel)), tr.cfg.per_alpha, tr.cfg.batch_size)[1]
        assert int((pri > 0).sum()) >= tr.cfg.batch_size
        np.testing.assert_array_equal(n(idx), np.asarray(want))


REFUSALS = {
    "eager loop": (dict(fused=False), "fused path"),
    "ac does not divide the ensemble": (dict(algo="ddpg"), "must divide"),
    "capacity": (dict(replay_capacity=255), "replay_capacity 255"),
    "batch": (dict(batch_size=31), "batch_size 31"),
    "per batch over a shard": (dict(prioritized=True, batch_size=96,
                                    replay_capacity=128),
                               "per-group ring shard"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_mesh_configs_are_refused_at_construction(case):
    """The reference's five refusals of ``_check_mesh``, on a 2x2 ac mesh
    (2 ring shards)."""
    kw, match = REFUSALS[case]
    cfg = SpreezeConfig(**{**CFG, "mesh": cpu_mesh(2, 2), "device": "cpu",
                           **kw})
    with pytest.raises(ValueError, match=match):
        SpreezeTrainer(cfg)


def test_a_mesh_on_another_device_type_is_refused():
    with pytest.raises(ValueError, match="primary device"):
        SpreezeTrainer(SpreezeConfig(**CFG, mesh=make_ac_mesh(
            1, 1, devices=["meta"]), device="cpu"))


# --------------------------------------------------------------------------- #
# resume on a mesh
# --------------------------------------------------------------------------- #

RESUME = dict(CFG, async_eval=False, snapshot_every_rounds=2,
              snapshot_min_interval_s=0.0, device="cpu")


def _resume_cfg(snap_dir, mesh=True, **kw):
    return SpreezeConfig(**{**RESUME, "snapshot_dir": snap_dir,
                            "mesh": cpu_mesh(2, 2) if mesh else None,
                            **kw})


def _keys(path):
    with np.load(path, allow_pickle=False) as data:
        return set(data.files)


def test_mesh_bundle_has_the_single_device_keys_and_places_back(tmp_path):
    """A mesh trainer's bundle holds the whole state under the
    single-device keys; a single-device trainer restores it, and so does
    a mesh trainer, which places it back."""
    mesh_tr = SpreezeTrainer(_resume_cfg(str(tmp_path / "m")))
    mesh_tr._warmup()
    path = resume_lib.snapshot_now(mesh_tr, None, round_i=0)
    one = SpreezeTrainer(_resume_cfg(str(tmp_path / "o"), mesh=False))
    assert _keys(path) == _keys(resume_lib.snapshot_now(one, None, 0))
    resume_lib.restore_trainer(one, path)
    back = SpreezeTrainer(_resume_cfg(str(tmp_path / "m")))
    resume_lib.restore_trainer(back, path)
    for tr in (one, back):
        assert_tree_equal(interop.replay_to_numpy(mp.whole_replay(mesh_tr)),
                          interop.replay_to_numpy(mp.whole_replay(tr)))
        assert_tree_equal(
            interop.algo_state_to_numpy(mp.whole_state(mesh_tr)),
            interop.algo_state_to_numpy(mp.whole_state(tr)))
    assert isinstance(back.replay.data["obs"], list)


def test_a_bundle_of_another_placement_is_refused(tmp_path):
    tr = SpreezeTrainer(_resume_cfg(str(tmp_path)))
    tr._warmup()
    path = resume_lib.snapshot_now(tr, None, round_i=0)
    with pytest.raises(checkpoint.CheckpointError,
                       match="different trainer config"):
        resume_lib.restore_trainer(
            SpreezeTrainer(_resume_cfg(str(tmp_path), placement="dp")),
            path)


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "per"])
def test_mesh_preempt_and_resume_is_bitwise_the_uninterrupted_run(
        tmp_path, prioritized):
    """SAC on a 2x2 ac mesh: 4 dispatches after the 32-frame warmup
    without a stop, against the same run preempted at round 4 and resumed
    from its snapshot."""
    frames = 32 + 4 * 16
    ref = SpreezeTrainer(_resume_cfg(None, prioritized=prioritized))
    ref.train(max_seconds=600, max_frames=frames)
    d = str(tmp_path)
    pre = SpreezeTrainer(_resume_cfg(
        d, prioritized=prioritized,
        fault_plan=faults.FaultPlan(preempt_round=4)))
    with pytest.raises(faults.Preempted) as ei:
        pre.train(max_seconds=600, max_frames=frames)
    res = SpreezeTrainer(_resume_cfg(d, prioritized=prioritized))
    res.train(max_seconds=600, max_frames=frames,
              resume_from=ei.value.snapshot_path)
    for a, b in ((ref.state, res.state), (ref.replay, res.replay),
                 (ref.env_states, res.env_states)):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert torch.equal(ref.draws.get_state(), res.draws.get_state())
    assert (ref.total_frames, ref.total_updates) == (res.total_frames,
                                                     res.total_updates)


def test_nan_injection_poisons_every_replica_and_rolls_back(tmp_path):
    """The fault plan's NaN reaches every replica's actor (so the mesh
    megastep's finite guard trips) and the rollback places the snapshot
    back on the mesh."""
    tr = SpreezeTrainer(_resume_cfg(
        str(tmp_path), fault_plan=faults.FaultPlan(nan_round=4)))
    with pytest.warns(UserWarning, match="rolled back"):
        tr.train(max_seconds=600, max_frames=6 * 16)
    assert tr.hp.lr == AlgoHP().lr * 0.5
    for rep in tr.state.replicas:
        assert all(bool(torch.isfinite(p).all())
                   for p in tree_leaves(rep.actor))


def test_auto_tune_runs_its_megastep_probe_on_the_mesh(monkeypatch):
    """``auto_tune(mesh=...)``: the fusion search's trainers run the mesh
    update."""
    calls = []
    call = mp.MeshUpdate.__call__

    def counting(self, *a):
        calls.append(self.layout.placement)
        return call(self, *a)

    monkeypatch.setattr(mp.MeshUpdate, "__call__", counting)
    tuned = adaptation.auto_tune("pendulum", "sac", bs_grid=(32, 64),
                                 env_grid=(1, 2), rpd_grid=(1, 2), iters=1,
                                 device="cpu", mesh=cpu_mesh(2, 2),
                                 placement="dp")
    assert tuned["rounds_per_dispatch"] in (1, 2)
    assert calls and set(calls) == {"dp"}
