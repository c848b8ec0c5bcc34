"""``launch.specs`` against the reference's: the dry run's stand-ins.

For all 10 architectures x the 4 input shapes: ``input_specs`` gives the
reference's model inputs (shapes and dtypes), ``decode_input_specs`` its
token, cache and position (the cache leaf by leaf), and
``shape_supported`` its verdict and its skip reason word for word. The
reference's side comes from ``jax.eval_shape`` (nothing allocated), the
port's lives on the meta device.
"""
import jax
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs as jspecs
from repro_torch._tree import leaves_with_path
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.launch import specs

DTYPES = {"int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def _shape_dtype(leaf):
    return tuple(leaf.shape), DTYPES[str(leaf.dtype)]


def _by_path(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in path)] = _shape_dtype(leaf)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_are_the_reference(arch, shape):
    jcfg, jshape = jax_get_config(arch), jax_get_shape(shape)
    cfg, pshape = get_config(arch), get_shape(shape)
    ok, why = specs.shape_supported(cfg, pshape)
    assert (ok, why) == jspecs.shape_supported(jcfg, jshape)
    if not ok:
        return
    want = {k: _shape_dtype(v)
            for k, v in jspecs.input_specs(jcfg, jshape).items()}
    got = specs.input_specs(cfg, pshape)
    assert all(v.device.type == "meta" for v in got.values())
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == want
    if pshape.kind != "decode":
        return
    jtoken, jcache, jpos = jspecs.decode_input_specs(jcfg, jshape)
    token, cache, pos = specs.decode_input_specs(cfg, pshape)
    assert (tuple(token.shape), token.dtype) == _shape_dtype(jtoken)
    assert (tuple(pos.shape), pos.dtype) == _shape_dtype(jpos)
    got = {"/".join(p): (tuple(t.shape), t.dtype)
           for p, t in leaves_with_path(cache)}
    assert got == _by_path(jcache)
    assert all(t.device.type == "meta" for _, t in leaves_with_path(cache))


def test_the_skips_are_the_reference_two_reasons():
    """long_500k: the enc-dec decoder, and every arch without a
    sub-quadratic decode."""
    reasons = {specs.shape_supported(get_config(a), get_shape("long_500k"))
               for a in ARCHS}
    assert len(reasons) == 3 and (True, "") in reasons
    skipped = [a for a in ARCHS if not specs.shape_supported(
        get_config(a), get_shape("long_500k"))[0]]
    assert sorted(skipped) == ["kimi-k2-1t-a32b", "paligemma-3b",
                               "qwen2-0.5b", "qwen2.5-32b", "smollm-360m",
                               "whisper-medium"]
