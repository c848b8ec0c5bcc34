"""The port's sharding rules against the reference's, leaf by leaf.

``distributed.sharding.param_spec`` / ``params_sharding_tree``,
``launch.specs.batch_shardings`` / ``cache_shardings`` and
``core.model_parallel._state_shardings_from_shapes`` give each leaf's
split as one entry a dimension; the reference's give ``NamedSharding``s
over a device-less ``AbstractMesh`` (as ``tests/test_sharding.py``
builds it). For every architecture's full-size parameter tree, its
optimizer state, its train batch and its decode_32k cache, at the
production meshes 16x16 and 2x16x16, each leaf's split must be the
reference's ``PartitionSpec``, dimension for dimension (a spec shorter
than the leaf reads as unsplit trailing dims). Nothing is allocated: the
reference's trees come from ``jax.eval_shape``, the port's live on the
meta device.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import factory as jfactory
from repro.core import model_parallel as jmp
from repro.rl.base import AlgoHP as JaxHP
from repro.rl.base import get_algo as jax_get_algo
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch._tree import leaves_with_path
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.core import model_parallel as mp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs
from repro_torch.models import factory
from repro_torch.rl.base import AlgoHP, get_algo
from repro_torch.train.optimizer import make_optimizer

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def abstract_mesh(shape):
    try:
        return AbstractMesh(tuple(shape.values()), tuple(shape.keys()))
    except TypeError:   # older jax: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(shape.items()))


def axis_mesh(name):
    return pmesh.make_production_mesh(multi_pod=name == "2x16x16")


def _jax_specs(tree):
    """{path: (spec padded to the leaf's rank)} of a NamedSharding tree
    over ``leaves`` (a tree of ShapeDtypeStructs of the same layout)."""
    shardings, leaves = tree
    out = {}
    for (path, ns), leaf in zip(
            jax.tree_util.tree_flatten_with_path(shardings)[0],
            jax.tree_util.tree_leaves(leaves)):
        spec = tuple(ns.spec)
        out[_path(path)] = (spec + (None,) * (len(leaf.shape) - len(spec)),
                            tuple(leaf.shape))
    return out


def _path(path) -> str:
    """A JAX key path as the port's ``leaves_with_path`` names it."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append("." + k.name)
        else:
            out.append(str(k.idx))
    return "/".join(out)


def _port_specs(specs_tree, leaves_tree):
    """{path: spec} of the port's split tree, walked along its leaves'
    tree (a split is a tuple: not a container)."""
    def walk(spec, keys):
        if isinstance(spec, dict):
            for k, v in spec.items():
                yield from walk(v, keys + (str(k),))
        elif isinstance(spec, (list, tuple)) and hasattr(spec, "_fields"):
            for f, v in zip(spec._fields, spec):
                yield from walk(v, keys + ("." + f,))
        elif isinstance(spec, list):
            for i, v in enumerate(spec):
                yield from walk(v, keys + (str(i),))
        elif spec is not None:
            yield "/".join(keys), spec
    got = dict(walk(specs_tree, ()))
    shapes = {"/".join(p): tuple(t.shape)
              for p, t in leaves_with_path(leaves_tree)}
    assert set(got) == set(shapes)
    return got, shapes


@functools.lru_cache(maxsize=None)
def reference_state(arch):
    cfg = jax_get_config(arch)
    params = jax.eval_shape(
        lambda k: jfactory.init_params(cfg, k, dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    opt = jax_make_optimizer("adamw", 3e-4)
    return params, jax.eval_shape(opt.init, params)


@functools.lru_cache(maxsize=None)
def port_state(arch):
    cfg = get_config(arch)
    params = factory.init_params(cfg, torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16, device="meta")
    return params, make_optimizer("adamw", 3e-4).init(params)


def _norm(spec):
    """A split as ``PartitionSpec`` prints it: a one-axis tuple as the
    axis's name, an empty one as None."""
    def one(entry):
        if isinstance(entry, tuple) and len(entry) <= 1:
            return entry[0] if entry else None
        return entry
    return tuple(one(e) for e in spec)


def _same(want_tree, got_specs, leaves):
    want = _jax_specs(want_tree)
    got, shapes = _port_specs(got_specs, leaves)
    assert set(got) == set(want)
    for path, (spec, shape) in want.items():
        assert shapes[path] == shape, path
        assert _norm(got[path]) == _norm(spec), (path, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_and_opt_state_split_as_the_reference(arch, mesh):
    jrules = jsh.standard_rules(abstract_mesh(MESHES[mesh]))
    rules = sh.standard_rules(axis_mesh(mesh))
    jparams, jopt = reference_state(arch)
    params, opt = port_state(arch)
    for jtree, tree in ((jparams, params), (jopt, opt)):
        _same((jsh.params_sharding_tree(jtree, jrules), jtree),
              sh.params_sharding_tree(tree, rules), tree)
    # the same through train_state_shardings
    got = specs.train_state_shardings(params, opt, rules)
    want = jspecs.train_state_shardings(jparams, jopt, jrules)
    _same((want[0], jparams), got[0], params)
    _same((want[1], jopt), got[1], opt)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_split_as_the_reference(arch, mesh):
    jrules = jsh.standard_rules(abstract_mesh(MESHES[mesh]))
    rules = sh.standard_rules(axis_mesh(mesh))
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        jbatch = jspecs.input_specs(jcfg, jax_get_shape(shape))
        batch = specs.input_specs(cfg, get_shape(shape))
        _same((jspecs.batch_shardings(jbatch, jrules), jbatch),
              specs.batch_shardings(batch, rules), batch)
    shape = "decode_32k"
    _, jcache, _ = jspecs.decode_input_specs(jcfg, jax_get_shape(shape))
    _, cache, _ = specs.decode_input_specs(cfg, get_shape(shape))
    _same((jspecs.cache_shardings(jcache, jrules), jcache),
          specs.cache_shardings(cache, rules), cache)


def _reference_rl_rules(mesh, placement):
    """The rules the reference's ``make_spreeze_update`` builds."""
    if placement == "dp":
        return jmp.standard_rules_for_rl(mesh)
    rules = jsh.spreeze_rules(mesh)
    if rules.ac is None:
        rules = jsh.MeshRules(mesh=mesh, batch=("data",), seq=rules.seq,
                              fsdp=rules.fsdp, tp=rules.tp, ac="data")
    return rules


@pytest.mark.parametrize("placement", ["ac", "dp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_rl_state_split_as_the_reference(algo, mesh, placement):
    jrules = _reference_rl_rules(abstract_mesh(MESHES[mesh]), placement)
    rules = mp._spreeze_rules(axis_mesh(mesh), placement)
    assert (rules.batch, rules.ac) == (tuple(jrules.batch), jrules.ac)
    jstate = jax.eval_shape(
        lambda k: jax_get_algo(algo).init_state(k, 26, 6, JaxHP(algo=algo)),
        jax.random.PRNGKey(0))
    state = get_algo(algo).init_state(torch.Generator().manual_seed(0), 26,
                                      6, AlgoHP(algo=algo), device="meta")
    _same((jmp._state_shardings_from_shapes(jstate, jrules), jstate),
          mp._state_shardings_from_shapes(state, rules), state)


def test_param_spec_cases_of_the_reference():
    """``tests/test_sharding.py``'s cases of the greedy 2-D split, and an
    expert dim, on the port's rules."""
    rules = sh.standard_rules(pmesh.make_production_mesh())
    jrules = jsh.standard_rules(abstract_mesh(MESHES["16x16"]))
    for shape, kw in (((4096, 4096), {}), ((32, 4096, 4096),
                                          {"stacked": True}),
                      ((14, 896), {}), ((8, 4096, 14336),
                                        {"expert_dim": 0}),
                      ((32, 384, 7168, 2048), {"stacked": True,
                                               "expert_dim": 1})):
        want = tuple(jsh.param_spec(shape, rules=jrules, **kw))
        want += (None,) * (len(shape) - len(want))
        assert _norm(sh.param_spec(shape, rules=rules, **kw)) == want


def test_rules_without_a_mesh_split_nothing():
    rules = sh.standard_rules(None)
    assert not rules.active
    assert sh.param_spec((4096, 4096), rules=rules) == (None, None)
    tree = sh.params_sharding_tree({"w": torch.empty(4, 8, device="meta")},
                                   rules)
    assert tree == {"w": (None, None)}


def test_meshes_of_the_reference():
    m = pmesh.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert pmesh.make_production_mesh(data=32, model=8).shape == {
        "data": 32, "model": 8}
    with pytest.raises(ValueError):
        pmesh.make_production_mesh(data=16, model=8)
    assert pmesh.make_debug_mesh(2, 2).shape == {"data": 2, "model": 2}
