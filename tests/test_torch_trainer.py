"""The port's LM training against the JAX package, on the CPU.

``factory.loss_fn``'s value and gradients against the reference's
``jax.value_and_grad`` (float32 compute, its jnp path) for reduced
qwen2-0.5b (remat on and off), h2o-danube-1.8b (an 80-token sequence
over its 64-token window), mixtral-8x7b (aux loss included),
whisper-medium, paligemma-3b, mamba2-130m (remat on and off) and
zamba2-1.2b at 5 layers (groups (0, 2), (2, 4), (4, 5)), the SSMs over
three chunks of 32; the optimizers against ``make_optimizer`` on
identical gradients; two ``make_train_step`` steps against the
reference's; ``train_loop``, one step of each SSM family and the
launcher's ``lm`` mode.
Parameters, optimizer states and batches are the reference's, carried
across through ``repro_torch.interop``; the JAX side runs under
``jax.jit``.

Tolerances (float32; each side sums matmuls, softmaxes and the
reductions of the backward in its own order):
  * the loss within 1e-5 relative (measured: 8e-8 or less); each
    gradient leaf within 2e-5 of its largest value (measured: 2.0e-6 at
    most over the six attention cases; 6.2e-6 over the SSM cases, in
    ``A_log``, whose gradient is a sum over every row and head that
    nearly cancels);
  * the optimizers within 1e-6 relative and 1e-9 absolute per element:
    the same float32 formulas on the same inputs;
  * two train steps: every parameter within 2 * steps * lr of the
    reference's, and all but 0.1% of the elements within 1e-6 + 1e-5
    |p|. Adam divides by sqrt(v) + eps, so a gradient element of ~1e-9
    whose sign differs between the two sides moves its parameter by
    +-lr on one and -+lr on the other: that bound is the most rounding
    can move an element, and the share says it is rare (measured: 3.5e-5
    at most, 111 of 1,313,024 elements past the second limit).
mixtral's gate values are rounded to bf16 (the reference's ``combine``,
at every compute dtype): a router logit a float32 ulp apart could move a
gate by a bf16 step, which would show here as a gap of ~2**-8; on this
data no gate moves, and mixtral is held to the same 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import RunConfig as JaxRunConfig
from repro.data.tokens import make_batch as jax_make_batch
from repro.models import factory as jfactory
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import interop
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, RunConfig
from repro_torch.data.tokens import batch_iterator
from repro_torch.launch import train as launch_train
from repro_torch.models import factory
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer

torch.set_num_threads(2)

B = 2
# (arch, total sequence length: a VLM's counts its patches)
FAMILIES = {"qwen2-0.5b": 32, "h2o-danube-1.8b": 80, "mixtral-8x7b": 80,
            "whisper-medium": 24, "paligemma-3b": 40, "mamba2-130m": 96,
            "zamba2-1.2b": 96}
# reduced() arguments beside the defaults: zamba2 at 5 layers, so that
# its last group of core layers is shorter than the others
REDUCE = {"zamba2-1.2b": dict(num_layers=5)}


def configs(arch, **kw):
    return (jax_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


def setup(arch, remat=True, **kw):
    """Both run configs at float32 compute, the reference's parameters
    and batch, and the port's copies (leaves requiring grad)."""
    jcfg, cfg = configs(arch, **{**REDUCE.get(arch, {}), **kw})
    seq = FAMILIES.get(arch, 32)
    jrc = JaxRunConfig(model=jcfg, shape=JaxShape("t", seq, B, "train"),
                       compute_dtype="float32", remat=remat)
    rc = RunConfig(model=cfg, shape=InputShape("t", seq, B, "train"),
                   compute_dtype="float32", remat=remat)
    params = jax.tree.map(np.asarray, jax.jit(
        jfactory.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    batch = jax_make_batch(jcfg, jrc.shape, jax.random.PRNGKey(1))
    port_params = tree_map(lambda p: p.requires_grad_(),
                           interop.to_tensors(params, "cpu"))
    port_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jrc, rc, params, batch, port_params, port_batch


def as_tree(like, leaves):
    """A list in ``tree_leaves`` order -> the tree of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def assert_trees_close(got, want, rel, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rel, f"{path}/{k}")
        return
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, path
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (path, err, scale)


@pytest.mark.parametrize("arch,remat", [
    ("qwen2-0.5b", True), ("qwen2-0.5b", False), ("h2o-danube-1.8b", True),
    ("mixtral-8x7b", True), ("whisper-medium", True),
    ("paligemma-3b", True), ("mamba2-130m", True), ("mamba2-130m", False),
    ("zamba2-1.2b", True)])
def test_loss_and_grads_match_the_reference(arch, remat):
    jrc, rc, params, batch, port_params, port_batch = setup(arch, remat)
    jcfg = jrc.model

    def loss(p, b):
        return jfactory.loss_fn(p, b, jcfg, dtype=jnp.float32, remat=remat)
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, batch)
    pl, pm, pg = trainer.value_and_grad(rc, port_params, port_batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    if arch == "mixtral-8x7b":
        assert float(pm["aux"]) > 0
    assert_trees_close(as_tree(port_params, pg),
                       jax.tree.map(np.asarray, jg), 2e-5)


def _grads(rng, params):
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        params)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.1)),
    ("adam", dict()),
    ("sgd", dict()),
    ("adamw", dict(weight_decay=0.1, grad_clip=1e-3)),
    ("adam", dict(warmup_steps=2, decay_steps=5)),
    ("sgd", dict(grad_clip=0.5, warmup_steps=3, decay_steps=4)),
])
def test_optimizer_matches_make_optimizer(name, kw):
    """Three steps of each side on the same gradients, the port starting
    from the reference's state after its first step (carried across)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [_grads(rng, params) for _ in range(4)]
    jo = jopt.make_optimizer(name, 1e-2, **kw)
    po = opt_lib.make_optimizer(name, 1e-2, **kw)
    jp, js = params, jo.init(params)
    jp, js = jo.update(grads[0], js, jp)
    pp = interop.to_tensors(jax.tree.map(np.asarray, jp), "cpu")
    ps = interop.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for g in grads[1:]:
        jp, js = jo.update(g, js, jp)
        pp, ps = po.update(tree_leaves(interop.to_tensors(g, "cpu")), ps, pp)
    for got, want in ((pp, jp), (ps.mu, js.mu), (ps.nu, js.nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    assert int(ps.step) == int(js.step) == 4
    back = interop.opt_state_to_numpy(ps)
    assert int(back["step"]) == 4


def test_schedule_and_clip_match_the_reference():
    sched = opt_lib.make_schedule(3e-4, 10, 100)
    jsched = jopt.make_schedule(3e-4, 10, 100)
    for s in (0, 5, 9, 10, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(sched(torch.tensor(s, dtype=torch.int32))),
            float(jsched(jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((4, 4)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        got, norm = opt_lib.clip_by_global_norm(interop.to_tensors(g, "cpu"),
                                                max_norm)
        want, jnorm = jopt.clip_by_global_norm(g, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


def test_two_train_steps_match_the_reference():
    """Reduced qwen2 (QKV bias, tied embeddings), adamw with weight decay
    0.1 and clipping at 1.0, two steps on two batches."""
    jrc, rc, params, batch, port_params, port_batch = setup("qwen2-0.5b")
    jrc = dataclasses.replace(jrc, weight_decay=0.1)
    rc = dataclasses.replace(rc, weight_decay=0.1)
    batch2 = jax_make_batch(jrc.model, jrc.shape, jax.random.PRNGKey(2))
    jstep = jax.jit(jtrainer.make_train_step(jrc))
    jo = jopt.make_optimizer(jrc.optimizer, jrc.learning_rate,
                             weight_decay=0.1, grad_clip=jrc.grad_clip)
    jp, js = params, jo.init(params)
    step = trainer.make_train_step(rc)
    ps = opt_lib.make_optimizer(rc.optimizer, rc.learning_rate).init(
        port_params)
    pp = port_params
    for b in (batch, batch2):
        jp, js, jm = jstep(jp, js, b)
        pb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        pp, ps, pm = step(pp, ps, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    lr, steps = rc.learning_rate, 2
    got = np.concatenate([a.detach().numpy().ravel()
                          for a in tree_leaves(pp)])
    want = np.concatenate([np.asarray(a).ravel() for a in
                           tree_leaves(interop.to_tensors(
                               jax.tree.map(np.asarray, jp), "cpu"))])
    diff = np.abs(got - want)
    assert diff.max() <= 2 * steps * lr, diff.max()
    assert (diff > 1e-6 + 1e-5 * np.abs(want)).mean() < 1e-3
    assert int(ps.step) == 2


def test_train_loop_runs_and_the_loss_falls_on_a_repeated_batch():
    _, rc, _, _, _, port_batch = setup("qwen2-0.5b")
    rc = dataclasses.replace(rc, learning_rate=3e-3)
    res = trainer.train_loop(rc, iter([port_batch] * 6), steps=6,
                             device="cpu")
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0] and res.steps_per_sec > 0


def test_batch_iterator_draws_batch_i_from_its_own_generator(monkeypatch):
    """Batch i depends on (seed, i) alone, on the device asked for; with
    no device named it is the card's, so without one it raises."""
    cfg = get_config("paligemma-3b").reduced()
    shape = InputShape("t", 40, B, "train")
    first = batch_iterator(cfg, shape, seed=3, device="cpu")
    b0, b1 = next(first), next(first)
    assert b0["tokens"].shape == (B, 40 - cfg.num_patch_tokens)
    assert b0["patches"].shape == (B, cfg.num_patch_tokens, cfg.d_model)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    again = batch_iterator(cfg, shape, seed=3, batch=4, device="cpu")
    next(again)
    assert torch.equal(next(again)["tokens"][:B], b1["tokens"])
    other = next(batch_iterator(cfg, shape, seed=4, device="cpu"))
    assert not torch.equal(other["tokens"], b0["tokens"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(batch_iterator(cfg, shape))


def test_launcher_lm_mode_on_the_cpu(capsys):
    for arch in ("qwen2-0.5b", "mamba2-130m"):
        assert launch_train.main(["lm", "--arch", arch, "--reduced",
                                  "--device", "cpu", "--steps", "3"]) == 0
        out = capsys.readouterr().out
        assert "step    0 loss" in out and "device: cpu" in out
        assert "steps/sec" in out and "final loss" in out
        assert np.isfinite(float(out.strip().splitlines()[-1].split()[-1]))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_families_train_one_step(arch):
    """One ``make_train_step`` step of the ssm and hybrid families on the
    CPU (bf16 compute, the defaults): the loss is ``loss_fn``'s at the
    start, finite, and every parameter leaf stays finite; the scan's
    weights (``A_log``, ``dt_bias``, ``in_proj``) move."""
    cfg = get_config(arch).reduced()
    rc = RunConfig(model=cfg, shape=InputShape("t", 64, B, "train"))
    params, state, opt = trainer.init_train_state(
        rc, torch.Generator().manual_seed(0))
    before = tree_map(lambda a: a.detach().clone(), params)
    batch = next(batch_iterator(cfg, rc.shape, device="cpu"))
    with torch.no_grad():
        want = float(factory.loss_fn(params, batch, cfg,
                                     dtype=torch.bfloat16)[0])
    params, state, metrics = trainer.make_train_step(rc, opt)(
        params, state, batch)
    assert float(metrics["loss"]) == pytest.approx(want, rel=1e-6)
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(params))
    for k in ("A_log", "dt_bias", "in_proj"):
        assert not torch.equal(params["layers"]["ssm"][k],
                               before["layers"]["ssm"][k]), k
