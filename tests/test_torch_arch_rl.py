"""The port's RL towers on LM backbones against the JAX package, on the CPU.

``rl.networks``' arch towers (``arch_policy_dist``, ``arch_q_value``)
and ``core.model_parallel.make_arch_spreeze_losses`` (the actor loss
after the critic loss, whose forwards it takes) against the
reference's, for a reduced config of each family (dense, MoE, enc-dec,
VLM, ssm, hybrid) at float32 compute (the reference's jnp path, under
``jax.jit``): the reference's parameters, carried across through
``repro_torch.interop``, and the same numpy inputs; the actor loss gets
the ``eps`` that ``jax.random.normal(key, mean.shape)`` gives the
reference. Then one ``remat=False`` case, one bf16 dense case against
the reference under ``use_pallas(True)`` (its Pallas kernels in
interpret mode), the two properties of ``tests/test_model_parallel.py``
(the target critics get no gradient; ``hp.gamma`` is used), one
``make_arch_spreeze_update`` step against ``jax.grad`` and the
reference's Adam, the ``llm_rl`` example's first steps against a step
rebuilt from the reference's functions (``examples/llm_rl.py``) on the
reference's draws, and the example run whole.

Tolerances (float32; each side sums the backbone's products, softmaxes
and backward reductions in its own order):
  * the towers' outputs within 1e-4 of the largest value (measured: a
    few 1e-6);
  * the losses within 1e-4 relative (the actor's ``log(1 - a^2)``
    rounds both sides' ``1 - a^2`` apart by ~1e-4 of itself where |a| is
    near 1: measured 1.4e-5 at mixtral), each gradient leaf within 2e-5
    of its largest value (measured: ~3e-6);
  * bf16: the towers' outputs within 2e-2 of the largest, the serving
    logits' limit (``tests/test_torch_serve.py``);
  * after Adam steps, every parameter within 2 lr a step of the
    reference's (Adam moves an element whose gradient is ~1e-9 by +-lr
    on either side's sign, ``tests/test_torch_trainer.py``'s bound), and
    all but 0.1% of the elements within 1e-6 + 1e-5 |p| + 1e-2 lr. The
    ``1e-2 lr`` term: an Adam step is lr times a ratio of the moments,
    which both sides' rounding moves where a gradient element is small;
    at the example's lr 3e-3, after 3 steps with the actor moving, 0.6%
    of the critics' elements lie past 1e-6 + 1e-5 |p| (the trainer's
    share limit, set at lr 3e-4), and 2.9e-5 past 1e-2 lr.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.configs import get_config as jax_get_config
from repro.core.model_parallel import \
    make_arch_spreeze_losses as jax_arch_losses
from repro.kernels.ops import use_pallas
from repro.rl import networks as jnets
from repro.rl.base import AlgoHP as JaxHP
from repro.train.optimizer import make_optimizer as jax_make_optimizer
from repro_torch import interop
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.core import model_parallel as mp
from repro_torch.examples import llm_rl
from repro_torch.rl import networks as nets
from repro_torch.rl.base import AlgoHP
from repro_torch.train.optimizer import make_optimizer

torch.set_num_threads(2)

B, A = 2, 4
F32 = jnp.float32
# arch: (tokens a sequence, reduced() arguments beside the defaults); the
# SSMs over two chunks of 32, zamba2 at 3 layers (groups (0, 2), (2, 3))
FAMILIES = {"qwen2-0.5b": (16, {}), "mixtral-8x7b": (16, {}),
            "whisper-medium": (16, {}), "paligemma-3b": (16, {}),
            "mamba2-130m": (64, {}), "zamba2-1.2b": (64, dict(num_layers=3))}


def to_port(tree, grad=True):
    """A JAX tree -> the port's tensors on the CPU (leaves requiring grad)."""
    out = interop.to_tensors(jax.tree.map(np.asarray, tree), "cpu")
    return tree_map(lambda a: a.requires_grad_(), out) if grad else out


def as_tree(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def close(got, want, rel, path=""):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, path
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (path, err, scale)


def trees_close(got, want, rel, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            trees_close(got[k], want[k], rel, f"{path}/{k}")
        return
    close(got, want, rel, path)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """Reduced ``arch`` on both sides, the reference's towers and inputs,
    and its outputs: the policy's (mean, log_std), the ensemble's Q
    values, and each loss's value and gradients (under ``jax.jit``)."""
    seq, kw = FAMILIES[arch]
    jcfg = jax_get_config(arch).reduced(**kw)
    cfg = get_config(arch).reduced(**kw)
    ka, kq, kl = jax.random.split(jax.random.PRNGKey(0), 3)
    actor = jnets.init_arch_policy(ka, jcfg, A)
    critics = jax.vmap(lambda k: jnets.init_arch_q(k, jcfg, A))(
        jax.random.split(kq, 2))
    target = jax.tree.map(lambda a: a * 0.99, critics)
    rng = np.random.default_rng(sum(map(ord, arch)))
    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq),
                                     dtype=np.int32),
              "act": np.tanh(rng.standard_normal((B, A))).astype(np.float32),
              "rew": rng.standard_normal(B).astype(np.float32),
              "done": np.array([0.0, 1.0], np.float32)}
    actor_loss, critic_loss = jax_arch_losses(jcfg, A, dtype=F32)

    @jax.jit
    def run(actor, critics, target, tokens, act, rew, done):
        dist = jnets.arch_policy_dist(actor, tokens, jcfg, dtype=F32)
        q = jax.vmap(lambda p: jnets.arch_q_value(p, tokens, act, jcfg,
                                                  dtype=F32))(critics)
        return dist, q, {
            "actor": jax.value_and_grad(actor_loss)(actor, critics, tokens,
                                                    kl),
            "critic": jax.value_and_grad(critic_loss)(
                critics, target, actor, tokens, act, rew, done, kl)}

    out = jax.tree.map(np.asarray, run(actor, critics, target, **inputs))
    eps = np.asarray(jax.random.normal(kl, (B, A)))
    return (jcfg, cfg, jax.tree.map(np.asarray, (actor, critics, target)),
            inputs, eps, out)


def port_inputs(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_towers_match_the_reference(arch):
    _, cfg, (actor, critics, _), inputs, _, (dist, q, _) = reference(arch)
    x = port_inputs(inputs)
    with torch.no_grad():
        mean, log_std = nets.arch_policy_dist(to_port(actor), x["tokens"],
                                              cfg, dtype=torch.float32)
        qs = nets.arch_ensemble_q_values(to_port(critics), x["tokens"],
                                         x["act"], cfg, dtype=torch.float32)
        q0 = nets.arch_q_value(to_port(jax.tree.map(lambda a: a[0],
                                                    critics)),
                               x["tokens"], x["act"], cfg,
                               dtype=torch.float32)
    for got, want in ((mean, dist[0]), (log_std, dist[1]), (qs, q),
                      (q0, q[0])):
        assert got.dtype == torch.float32
        close(got, want, 1e-4)


@pytest.mark.parametrize("loss", ["actor", "critic"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_grads_match_the_reference(arch, loss):
    _, cfg, (actor, critics, target), inputs, eps, out = reference(arch)
    want_loss, want_grads = out[2][loss]
    x = port_inputs(inputs)
    actor_loss, critic_loss = mp.make_arch_spreeze_losses(
        cfg, A, dtype=torch.float32)
    pa, pq = to_port(actor), to_port(critics)
    # the actor loss takes the critic loss's forwards, as in the update
    got = critic_loss(pq, to_port(target), pa, x["tokens"], x["act"],
                      x["rew"], x["done"])
    wrt = pq
    if loss == "actor":
        got = actor_loss(pa, pq, x["tokens"], torch.from_numpy(eps))
        wrt = pa
    np.testing.assert_allclose(float(got), float(want_loss), rtol=1e-4)
    trees_close(as_tree(wrt, mp.tower_grads(got, wrt)), want_grads, 2e-5)


def test_remat_off_matches_the_reference():
    """The towers' outputs and the gradients of their sum with every
    layer's activations kept (``remat=False``), dense."""
    jcfg, cfg, (actor, critics, _), inputs, _, _ = reference("qwen2-0.5b")
    critic = jax.tree.map(lambda a: a[0], critics)

    def total(ap, qp, tokens, act):
        mean, log_std = jnets.arch_policy_dist(ap, tokens, jcfg, dtype=F32,
                                               remat=False)
        q = jnets.arch_q_value(qp, tokens, act, jcfg, dtype=F32,
                               remat=False)
        return mean.sum() + log_std.sum() + q.sum()

    want, (ga, gq) = jax.jit(jax.value_and_grad(total, argnums=(0, 1)))(
        actor, critic, inputs["tokens"], inputs["act"])
    x = port_inputs(inputs)
    pa, pq = to_port(actor), to_port(critic)
    mean, log_std = nets.arch_policy_dist(pa, x["tokens"], cfg,
                                          dtype=torch.float32, remat=False)
    got = (mean.sum() + log_std.sum() +
           nets.arch_q_value(pq, x["tokens"], x["act"], cfg,
                             dtype=torch.float32, remat=False).sum())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    grads = mp.tower_grads(got, {"a": pa, "q": pq})
    trees_close(as_tree({"a": pa, "q": pq}, grads),
                jax.tree.map(np.asarray, {"a": ga, "q": gq}), 2e-5)


def test_bf16_towers_match_the_pallas_reference():
    """bf16 compute (the default) against the reference's towers under
    ``use_pallas(True)``, whose rmsnorm and flash attention the port's
    kernels follow, within the bf16 logit limit."""
    jcfg, cfg, (actor, critics, _), inputs, _, _ = reference("qwen2-0.5b")
    critic = jax.tree.map(lambda a: a[0], critics)
    with use_pallas(True):
        (jm, jl), jq = jax.jit(lambda ap, qp, t, a: (
            jnets.arch_policy_dist(ap, t, jcfg),
            jnets.arch_q_value(qp, t, a, jcfg)))(
                actor, critic, inputs["tokens"], inputs["act"])
    x = port_inputs(inputs)
    with torch.no_grad():
        mean, log_std = nets.arch_policy_dist(to_port(actor, False),
                                              x["tokens"], cfg)
        q = nets.arch_q_value(to_port(critic, False), x["tokens"], x["act"],
                              cfg)
    for got, want in ((mean, jm), (log_std, jl), (q, jq)):
        assert got.dtype == torch.float32
        close(got, want, 2e-2)


def _arch_setup(gamma):
    """``tests/test_model_parallel.py``'s setup, on the port: the critics
    a tower and 1.01 times it, the targets 0.99 times those."""
    cfg = get_config("qwen2-0.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    actor = nets.init_arch_policy(gen, cfg, 4)
    q1 = nets.init_arch_q(gen, cfg, 4)
    qs = tree_map(lambda a: torch.stack([a, a * 1.01]).requires_grad_(), q1)
    tgt = tree_map(lambda a: (a.detach() * 0.99).requires_grad_(), qs)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    act = torch.tanh(torch.randn((2, 4), generator=gen))
    _, critic_loss = mp.make_arch_spreeze_losses(
        cfg, 4, dtype=torch.float32, hp=AlgoHP(gamma=gamma))
    return critic_loss, (qs, tgt, actor, tokens, act,
                         torch.arange(2, dtype=torch.float32),
                         torch.tensor([0.0, 1.0]))


def test_arch_critic_target_carries_no_gradient():
    critic_loss, args = _arch_setup(gamma=0.99)
    loss = critic_loss(*args)
    for g in mp.tower_grads(loss, args[1]):
        assert torch.equal(g, torch.zeros_like(g))
    # while the online critic does receive gradient
    assert any(float(g.abs().max()) > 0
               for g in mp.tower_grads(critic_loss(*args), args[0]))


def test_arch_critic_uses_hp_gamma():
    l_hi, args = _arch_setup(gamma=0.99)
    l_lo, _ = _arch_setup(gamma=0.0)
    # gamma=0's target is just rew: the two losses must differ on the
    # not-done row (identical inputs otherwise)
    assert float(l_hi(*args)) != pytest.approx(float(l_lo(*args)))


@pytest.mark.parametrize("dtype", [F32, jnp.bfloat16])
def test_interop_carries_the_arch_towers(dtype):
    """The reference's towers (nested dicts of stacked ``(L, ...)``
    leaves, the ``(2, ...)`` critic stack, bf16 leaves) cross to the port
    and back bit for bit, in the layout, shapes and dtypes of the port's
    own ``init_arch_policy`` / ``init_arch_ensemble_q``; ``act_in`` is
    drawn at scale 3."""
    jcfg = jax_get_config("zamba2-1.2b").reduced(num_layers=3)
    cfg = get_config("zamba2-1.2b").reduced(num_layers=3)
    ka, kq = jax.random.split(jax.random.PRNGKey(2))
    ref = {"actor": jnets.init_arch_policy(ka, jcfg, A, dtype=dtype),
           "critics": jax.vmap(lambda k: jnets.init_arch_q(
               k, jcfg, A, dtype=dtype))(jax.random.split(kq, 2))}
    ref = jax.tree.map(np.asarray, ref)
    back = interop.to_numpy(interop.to_tensors(ref, "cpu"))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    tdtype = torch.float32 if dtype == F32 else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    own = interop.to_numpy({
        "actor": nets.init_arch_policy(gen, cfg, A, dtype=tdtype),
        "critics": nets.init_arch_ensemble_q(gen, cfg, A, dtype=tdtype)})
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(ref)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    std = np.asarray(own["critics"]["act_in"]["w"], np.float64).std()
    assert abs(std / (3.0 / np.sqrt(A)) - 1) < 0.1


def test_update_matches_the_reference():
    """One ``make_arch_spreeze_update`` (both losses' gradients at the
    current parameters, then Adam on each) against the reference's
    ``jax.grad`` of its two losses and its Adam, dense, float32."""
    jcfg, cfg, (actor, critics, target), inputs, eps, _ = reference(
        "qwen2-0.5b")
    key = jax.random.split(jax.random.PRNGKey(0), 3)[2]
    actor_loss, critic_loss = jax_arch_losses(jcfg, A, dtype=F32)
    opt = jax_make_optimizer("adam", JaxHP().lr)

    @jax.jit
    def update(actor, critics, oa, oq, tokens, act, rew, done):
        cl, gq = jax.value_and_grad(critic_loss)(critics, target, actor,
                                                 tokens, act, rew, done, key)
        al, ga = jax.value_and_grad(actor_loss)(actor, critics, tokens, key)
        critics, oq = opt.update(gq, oq, critics)
        actor, oa = opt.update(ga, oa, actor)
        return actor, critics, cl, al

    ja, jq, jcl, jal = update(actor, critics, opt.init(actor),
                              opt.init(critics), **inputs)
    pa, pq = to_port(actor), to_port(critics)
    popt = make_optimizer("adam", AlgoHP().lr)
    x = port_inputs(inputs)
    cl, al = mp.make_arch_spreeze_update(cfg, popt, A,
                                         dtype=torch.float32)(
        pa, pq, to_port(target, False), popt.init(pa), popt.init(pq),
        x["tokens"], x["act"], x["rew"], x["done"], torch.from_numpy(eps))
    np.testing.assert_allclose([float(cl), float(al)],
                               [float(jcl), float(jal)], rtol=1e-5)
    _params_close([pa, pq], [ja, jq], steps=1, lr=AlgoHP().lr)


def _params_close(got, want, steps, lr):
    got = np.concatenate([a.detach().numpy().ravel()
                          for a in tree_leaves(got)])
    want = np.concatenate([np.asarray(a).ravel()
                           for a in jax.tree.leaves(want)])
    d = np.abs(got - want)
    assert d.max() <= 2 * steps * lr, d.max()
    assert (d > 1e-6 + 1e-5 * np.abs(want) + 1e-2 * lr).mean() < 1e-3


class JaxExampleDraws:
    """``examples/llm_rl.py``'s draws (``PRNGKey(seed)``; the example's is
    0), as the port's example takes them: its towers carried across, the
    task from ``kd``, then each step's (near, far, coin) from the folded
    key's split."""

    def __init__(self, jcfg, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.ka, self.kq, self.kd = jax.random.split(self.key, 3)
        self.jcfg = jcfg

    def reference_towers(self):
        """The reference's actor and stacked critics, as its example
        draws them."""
        actor = jnets.init_arch_policy(self.ka, self.jcfg, llm_rl.ACT_DIM)
        critics = jax.vmap(lambda k: jnets.init_arch_q(
            k, self.jcfg, llm_rl.ACT_DIM))(jax.random.split(self.kq, 2))
        return actor, critics

    def towers(self, cfg):
        return tuple(to_port(t) for t in self.reference_towers())

    def task(self, cfg):
        B_, S = llm_rl.BATCH, llm_rl.SEQ
        tokens = jax.random.randint(self.kd, (B_, S), 0,
                                    self.jcfg.vocab_size)
        target = jnp.tanh(jax.random.normal(self.kd, (B_, llm_rl.ACT_DIM)))
        return (torch.from_numpy(np.array(tokens)).long(),
                torch.from_numpy(np.array(target)))

    def step(self, i):
        self.key = jax.random.fold_in(self.key, i)
        k1, k2 = jax.random.split(self.key)
        shape = (llm_rl.BATCH, llm_rl.ACT_DIM)
        draws = (jax.random.normal(k1, shape), jax.random.normal(k2, shape),
                 jax.random.bernoulli(k2, 0.5, (llm_rl.BATCH, 1)))
        return tuple(torch.from_numpy(np.array(d)) for d in draws)


def _jax_example_step(jcfg, tokens, target):
    """``examples/llm_rl.py``'s jitted step (lines 40-80), rebuilt from the
    reference's functions, with its draws as arguments."""
    opt = jax_make_optimizer("adam", llm_rl.LR)

    def reward_fn(a):
        return -jnp.sum((a - target) ** 2, -1)

    @jax.jit
    def step(actor, critics, oa, oq, near, far, coin, do_actor):
        mean, _ = jnets.arch_policy_dist(actor, tokens, jcfg, dtype=F32)
        a_seen = jnp.where(coin, jnp.tanh(mean + llm_rl.EXPLORE * near),
                           jnp.tanh(far))
        r = reward_fn(a_seen)

        def critic_loss(qp):
            q = jax.vmap(lambda p: jnets.arch_q_value(
                p, tokens, a_seen, jcfg, dtype=F32))(qp)
            return jnp.mean((q - r[None]) ** 2)

        cl, gq = jax.value_and_grad(critic_loss)(critics)
        critics, oq = opt.update(gq, oq, critics)

        def actor_loss(ap):
            mean, _ = jnets.arch_policy_dist(ap, tokens, jcfg, dtype=F32)
            q = jax.vmap(lambda p: jnets.arch_q_value(
                p, tokens, jnp.tanh(mean), jcfg, dtype=F32))(critics).min(0)
            return -jnp.mean(q)

        al, ga = jax.value_and_grad(actor_loss)(actor)
        cand_actor, cand_oa = opt.update(ga, oa, actor)
        actor = jax.tree.map(lambda n, o: jnp.where(do_actor, n, o),
                             cand_actor, actor)
        oa = jax.tree.map(lambda n, o: jnp.where(do_actor, n, o),
                          cand_oa, oa)
        return actor, critics, oa, oq, cl, al

    return opt, step


@pytest.mark.parametrize("do_actor", [False, True])
def test_example_steps_match_the_reference(do_actor):
    """The port's example's first 3 steps against the reference's step on
    the reference's towers and draws: with the actor held (the critic
    warm-up) and moving."""
    jcfg = jax_get_config("smollm-360m").reduced(num_layers=2, d_model=128)
    cfg = llm_rl.example_config()
    jdraws, pdraws = JaxExampleDraws(jcfg), JaxExampleDraws(jcfg)
    actor, critics = jdraws.reference_towers()
    pa, pq = pdraws.towers(cfg)
    tokens, target = pdraws.task(cfg)
    jopt, jstep = _jax_example_step(jcfg, jnp.asarray(tokens.numpy(),
                                                      jnp.int32),
                                    jnp.asarray(target.numpy()))
    jdraws.task(cfg)
    popt = make_optimizer("adam", llm_rl.LR)
    poa, poq = popt.init(pa), popt.init(pq)
    step, _ = llm_rl.make_step(cfg, tokens, target, popt)
    ja, jq, joa, joq = actor, critics, jopt.init(actor), jopt.init(critics)
    for i in range(3):
        draws = pdraws.step(i)
        jdraws.step(i)
        ja, jq, joa, joq, jcl, jal = jstep(
            ja, jq, joa, joq, *(jnp.asarray(d.numpy()) for d in draws),
            jnp.asarray(do_actor))
        cl, al = step(pa, pq, poa, poq, *draws, do_actor=do_actor)
        np.testing.assert_allclose([float(cl), float(al)],
                                   [float(jcl), float(jal)], rtol=1e-4)
        _params_close(pq, jq, steps=i + 1, lr=llm_rl.LR)
        _params_close(pa, ja, steps=i + 1, lr=llm_rl.LR)
    if not do_actor:
        for a, b in zip(tree_leaves(pa), jax.tree.leaves(actor)):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_example_runs_whole_and_improves(capsys):
    """``python -m repro_torch.examples.llm_rl --device cpu``: 200 steps,
    its printouts, and its check (``llm_rl.warmup_check``: the critic
    loss's mean over the last 10 warm-up steps below that over the first
    10; at seed 0 on the CPU 2.02 against 6.79). The reward's gain is
    printed, not checked: it reads where tanh saturates each action
    component, which float32 rounding decides (PERF.md §6)."""
    assert llm_rl.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("initial mean reward: ")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == llm_rl.STEPS // llm_rl.PRINT_EVERY
    assert lines[-2].startswith("final mean reward: ")
    assert lines[-1].startswith("warm-up critic loss: first 10 steps ")
    assert "reward gain" in lines[-1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_example_check_holds_at_seeds(seed):
    """The example's check on its own draws at seeds 0-3 (its warm-up
    alone: the check reads the warm-up's critic losses). Over seeds 0-15
    it held for the reference's loop, the port on the reference's draws
    and the port's example alike, the last 10 steps' mean at most 0.54 of
    the first 10's (this module run as a script)."""
    out = llm_rl.run("cpu", draws=llm_rl.Draws(seed, "cpu"),
                     log=lambda *_: None, steps=llm_rl.WARMUP)
    assert len(out["warmup_critic_losses"]) == llm_rl.WARMUP
    first, last, holds = llm_rl.warmup_check(out["warmup_critic_losses"])
    assert holds, (first, last)


def _seed_sweep(seeds):
    """``llm_rl``'s two checks seed by seed, on the CPU: the reward's gain
    (the reference's ``final > reward0 + 0.5``) and the port's
    ``warmup_check`` (the critic loss's mean over the last 10 warm-up steps
    below that over the first 10), for the reference's loop
    (``examples/llm_rl.py`` at ``PRNGKey(seed)``, rebuilt from its
    functions), the port's loop on the reference's towers and draws, and
    the port's example on its own draws (``Draws(seed)``). One JSON line a
    run."""
    import json
    jcfg = jax_get_config("smollm-360m").reduced(num_layers=2, d_model=128)

    def reference_run(seed):
        draws = JaxExampleDraws(jcfg, seed)
        actor, critics = draws.reference_towers()
        tokens, target = (jnp.asarray(t.numpy()) for t in draws.task(None))
        tokens = tokens.astype(jnp.int32)
        opt, step = _jax_example_step(jcfg, tokens, target)
        oa, oq = opt.init(actor), opt.init(critics)

        def reward():
            mean, _ = jnets.arch_policy_dist(actor, tokens, jcfg, dtype=F32)
            return float(jnp.mean(-jnp.sum((jnp.tanh(mean) - target) ** 2,
                                           -1)))

        reward0, warmup = reward(), []
        for i in range(llm_rl.STEPS):
            near, far, coin = (jnp.asarray(d.numpy()) for d in draws.step(i))
            actor, critics, oa, oq, cl, _ = step(
                actor, critics, oa, oq, near, far, coin,
                jnp.asarray(i >= llm_rl.WARMUP))
            if i < llm_rl.WARMUP:
                warmup.append(float(cl))
        return {"reward0": reward0, "final": reward(),
                "warmup_critic_losses": warmup}

    def port_run(seed):
        """The port's example, and how far its final actions saturate:
        the range of |mean| and the largest tanh'(mean)."""
        draws, held = llm_rl.Draws(seed, "cpu"), {}
        towers, task = draws.towers, draws.task
        draws.towers = lambda cfg: held.setdefault("towers", towers(cfg))
        draws.task = lambda cfg: held.setdefault("task", task(cfg))
        out = llm_rl.run("cpu", draws=draws, log=lambda *_: 0)
        with torch.no_grad():
            mean, _ = nets.arch_policy_dist(held["towers"][0],
                                            held["task"][0],
                                            llm_rl.example_config(),
                                            dtype=torch.float32)
        out["saturation"] = {
            "abs_mean": [float(mean.abs().min()), float(mean.abs().max())],
            "max_dtanh": float((1 - torch.tanh(mean) ** 2).max())}
        return out

    runs = {"reference": reference_run,
            "port on the reference's draws": lambda seed: llm_rl.run(
                "cpu", draws=JaxExampleDraws(jcfg, seed), log=lambda *_: 0),
            "port": port_run}
    for seed in seeds:
        for label, run in runs.items():
            out = run(seed)
            gain = out["final"] - out["reward0"]
            first, last, holds = llm_rl.warmup_check(
                out["warmup_critic_losses"])
            print(json.dumps({"run": label, "seed": seed,
                              "reward0": out["reward0"],
                              "final": out["final"], "gain": gain,
                              "holds": gain > 0.5,
                              "warmup_first": first, "warmup_last": last,
                              "warmup_ratio": last / first,
                              "warmup_holds": holds,
                              **out.get("saturation", {})}), flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/test_torch_arch_rl.py
    #     [FIRST LAST]   (seeds FIRST..LAST, 0 15 by default)
    import sys
    first, last = (int(a) for a in (sys.argv[1:] or ["0", "15"]))
    _seed_sweep(range(first, last + 1))
