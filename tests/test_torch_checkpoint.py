"""The port's ``.npz`` checkpoint channel (``train/checkpoint.py``): the
cases of ``tests/test_checkpoint.py`` on tensor trees, and files written
by either package restored by the other."""
import errno
import os
from typing import Any, NamedTuple

import jax
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_sac_state, to_np

import repro  # noqa: F401
from repro.train import checkpoint as jax_checkpoint
from repro_torch import interop
from repro_torch.train import checkpoint

torch.set_num_threads(2)


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3)}


def _no_temp(path):
    return [f for f in os.listdir(path) if f.endswith(".tmp")] == []


def test_save_restore_roundtrip_leaves_no_temp(tmp_path):
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, _tree(), metadata={"step": 7})
    out, meta = checkpoint.restore(path, _tree())
    assert meta == {"step": 7}
    torch.testing.assert_close(out["w"], _tree()["w"], rtol=0, atol=0)
    assert _no_temp(tmp_path)


def test_save_unlinks_temp_on_write_failure(tmp_path, monkeypatch):
    """A failed write neither leaks its temp file nor touches the good
    checkpoint already there."""
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, _tree())
    before = open(path, "rb").read()

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save(path, _tree(), metadata={"step": 8})
    assert _no_temp(tmp_path), "failed save leaked its temp file"
    assert open(path, "rb").read() == before


def test_restore_key_mismatch_names_offenders(tmp_path):
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, _tree())
    like = {"w": _tree()["w"], "extra": torch.zeros(2)}
    with pytest.raises(checkpoint.CheckpointError) as ei:
        checkpoint.restore(path, like)
    assert ei.value.missing == ("extra",)
    assert ei.value.unexpected == ("b",)


def test_restore_shape_mismatch_names_leaf(tmp_path):
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, _tree())
    like = {"w": torch.zeros(3, 2), "b": _tree()["b"]}      # transposed
    with pytest.raises(checkpoint.CheckpointError) as ei:
        checkpoint.restore(path, like)
    assert any("w" in m and "shape" in m for m in ei.value.mismatched)


def test_restore_dtype_cross_kind_rejected_same_kind_cast_ok(tmp_path):
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, {"x": torch.arange(4, dtype=torch.float32)})
    out, _ = checkpoint.restore(path, {"x": torch.zeros(4,
                                                        dtype=torch.float16)})
    assert out["x"].dtype == torch.float16
    with pytest.raises(checkpoint.CheckpointError) as ei:
        checkpoint.restore(path, {"x": torch.zeros(4, dtype=torch.int32)})
    assert any("x" in m and "dtype" in m for m in ei.value.mismatched)


def test_save_retries_transient_then_succeeds(tmp_path, monkeypatch):
    path = str(tmp_path / "actor.npz")
    orig = np.savez
    fails = {"left": 2}

    def flaky(*a, **kw):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise OSError("device busy")
        return orig(*a, **kw)

    monkeypatch.setattr(np, "savez", flaky)
    checkpoint.save(path, _tree(), retries=3, backoff_s=0.001)
    assert fails["left"] == 0
    out, _ = checkpoint.restore(path, _tree())
    torch.testing.assert_close(out["w"], _tree()["w"], rtol=0, atol=0)
    assert _no_temp(tmp_path)


def test_save_nontransient_oserror_raises_immediately(tmp_path,
                                                      monkeypatch):
    path = str(tmp_path / "actor.npz")
    calls = {"n": 0}

    def denied(*a, **kw):
        calls["n"] += 1
        raise OSError(errno.EACCES, "permission denied")

    monkeypatch.setattr(np, "savez", denied)
    with pytest.raises(OSError):
        checkpoint.save(path, _tree(), retries=5, backoff_s=0.001)
    assert calls["n"] == 1, "non-transient error was retried"
    assert _no_temp(tmp_path)


def test_restore_keeps_the_structure_and_dtype_of_like(tmp_path):
    """Nested dicts and tuples come back as they were; each leaf takes
    its ``like`` leaf's dtype and device; ``latest_step`` reads the
    step files."""
    path = str(tmp_path / "step_12.npz")
    tree = {"a": (torch.ones(2), {"c": torch.arange(3)}), "s": torch.ones(())}
    checkpoint.save(path, tree)
    checkpoint.save(str(tmp_path / "step_3.npz"), tree)
    like = {"a": (torch.zeros(2, dtype=torch.float64),
                  {"c": torch.zeros(3, dtype=torch.int64)}),
            "s": torch.zeros(())}
    out, meta = checkpoint.restore(path, like)
    assert meta == {}
    assert isinstance(out["a"], tuple)
    assert out["a"][0].dtype == torch.float64
    assert out["a"][1]["c"].tolist() == [0, 1, 2]
    assert out["s"].shape == () and float(out["s"]) == 1.0
    assert checkpoint.latest_step(str(tmp_path)) == 12
    assert checkpoint.latest_step(str(tmp_path / "none")) == -1


def test_a_jax_written_actor_restores_in_the_port(tmp_path):
    """The same ``l0/w`` key layout: an actor saved by the JAX package
    restores into the port's actor tree bit for bit."""
    _, state = jax_sac_state(seed=3)
    path = str(tmp_path / "actor.npz")
    jax_checkpoint.save(path, state.actor, metadata={"round": 4})
    like = interop.algo_state_from_numpy(to_np(jax_sac_state(seed=4)[1]),
                                         "cpu").actor
    out, meta = checkpoint.restore(path, like)
    assert meta == {"round": 4}
    want = to_np(state.actor)
    assert set(out) == set(want)
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(out[layer][k].numpy(),
                                          want[layer][k])


def test_a_port_written_actor_restores_in_jax(tmp_path):
    _, state = jax_sac_state(seed=5)
    actor = interop.algo_state_from_numpy(to_np(state), "cpu").actor
    path = str(tmp_path / "actor.npz")
    checkpoint.save(path, actor, metadata={"round": 9})
    out, meta = jax_checkpoint.restore(path, jax_sac_state(seed=6)[1].actor)
    assert meta == {"round": 9}
    for a, b in zip(jax.tree.leaves(to_np(out)),
                    jax.tree.leaves(to_np(state.actor))):
        np.testing.assert_array_equal(a, b)


class S(NamedTuple):
    """The smallest bundle-like NamedTuple: a dict field and a leaf."""
    actor: Any
    step: Any


def _stored_keys(path):
    with np.load(path, allow_pickle=False) as data:
        return set(data.files) - {"__meta__"}


def _nt_tree(lib):
    """``{"state": S(actor={"w": ones(2)}, step=zeros(()))}`` as tensors
    (``torch``) or numpy arrays (``np``)."""
    return {"state": S(actor={"w": lib.ones(2)}, step=lib.zeros(()))}


def _none_tree(lib):
    """A tree with a ``None`` leaf, as TD3's and DDPG's ``opt_alpha``."""
    return {"state": {"a": lib.ones(2), "opt_alpha": None}}


def test_a_namedtuple_is_keyed_by_field_and_restores(tmp_path):
    """A NamedTuple's fields are keyed ``.<field>``, the key the
    reference's ``GetAttrKey`` prints, and it is rebuilt by field."""
    path = str(tmp_path / "nt.npz")
    checkpoint.save(path, _nt_tree(torch))
    assert _stored_keys(path) == {"state/.actor/w", "state/.step"}
    out, _ = checkpoint.restore(path, {"state": S(actor={"w": torch.zeros(2)},
                                                  step=torch.ones(()))})
    assert type(out["state"]) is S
    assert out["state"].actor["w"].tolist() == [1.0, 1.0]
    assert float(out["state"].step) == 0.0


def test_a_none_leaf_writes_no_key_and_restores_as_none(tmp_path):
    """``None`` is an empty subtree, as in JAX: no key, and ``None``
    back where ``like`` has it."""
    path = str(tmp_path / "none.npz")
    checkpoint.save(path, _none_tree(torch))
    assert _stored_keys(path) == {"state/a"}
    out, _ = checkpoint.restore(path, {"state": {"a": torch.zeros(2),
                                                 "opt_alpha": None}})
    assert out["state"]["opt_alpha"] is None
    assert out["state"]["a"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("make", [_nt_tree, _none_tree],
                         ids=["namedtuple", "none_leaf"])
def test_both_packages_write_the_same_keys(tmp_path, make):
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save(ours, make(torch))
    jax_checkpoint.save(theirs, make(np))
    assert _stored_keys(ours) == _stored_keys(theirs)


@pytest.mark.parametrize("make", [_nt_tree, _none_tree],
                         ids=["namedtuple", "none_leaf"])
def test_a_jax_written_tree_restores_in_the_port(tmp_path, make):
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, make(np), metadata={"round": 2})
    like = jax.tree.map(lambda x: torch.full(np.shape(x), 7.0), make(np))
    out, meta = checkpoint.restore(path, like)
    assert meta == {"round": 2}
    assert jax.tree.structure(jax.tree.map(np.asarray, out)) == \
        jax.tree.structure(make(np))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(make(np))):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("make", [_nt_tree, _none_tree],
                         ids=["namedtuple", "none_leaf"])
def test_a_port_written_tree_restores_in_jax(tmp_path, make):
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, make(torch), metadata={"round": 3})
    like = jax.tree.map(lambda x: np.full(np.shape(x), 7.0, np.float32),
                        make(np))
    out, meta = jax_checkpoint.restore(path, like)
    assert meta == {"round": 3}
    assert jax.tree.structure(out) == jax.tree.structure(make(np))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(make(np))):
        np.testing.assert_array_equal(np.asarray(a), b)
