"""Spreeze at LLM scale: an assigned architecture as the actor and critic
backbone (RLHF-style towers), the paper's dual-GPU actor-critic model
parallelism generalised to an actor LM and two critic LMs. Counterpart
of ``examples/llm_rl.py``.

A REDUCED smollm-360m backbone (2 layers, d_model 128) on a token-level
continuous-control task: the observation is a token sequence, the policy
head emits a continuous action, and the reward is ``-|a - target|^2``
for a fixed target a sequence. The critics regress Q(s, a) onto the
observed reward (a bandit), over actions that mix exploration noise
around the policy with uniform coverage; the actor ascends the critics'
min-Q of its own action, from step 50 on (the critic warm-up). Float32
compute, Adam at 3e-3, random weights from seed 0. It exits with an
``AssertionError`` unless the critics learn during the warm-up: the mean
critic loss of its last ``CHECK_SPAN`` steps must lie below that of its
first ``CHECK_SPAN`` (``warmup_check``). It prints the reward's gain and
does not check it: the policy ends with every action component
saturated, so the final reward is the signs they saturated to, which
float32 rounding decides (at seed 0 the gain is +0.60 on the CPU and
-0.15 on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.llm_rl [--device cpu]

(the card by default: the backbones run through the hand-written
rmsnorm and flash attention kernels and their backward kernels).
"""
import argparse

import torch

from repro_torch import card_line, resolve_device
from repro_torch._tree import tree_map
from repro_torch.configs import get_config
from repro_torch.core.model_parallel import tower_grads
from repro_torch.rl import networks as nets
from repro_torch.train.optimizer import make_optimizer

SEQ, BATCH, ACT_DIM, STEPS = 16, 8, 4, 200
WARMUP = 50           # critic-only steps before the actor moves
LR = 3e-3
PRINT_EVERY = 25
EXPLORE = 0.3         # the near actions' noise scale
SEED = 0
CHECK_SPAN = 10       # warm-up steps averaged at each end by the check


def example_config():
    return get_config("smollm-360m").reduced(num_layers=2, d_model=128)


class Draws:
    """The example's randomness from one CPU generator, moved to
    ``device``, so that every device starts from the same numbers: the
    towers, the task (tokens and target) and each step's exploration
    draws. A test hands ``run`` another source with the same methods."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def towers(self, cfg):
        """The actor and the stacked double-Q critics (float32), each leaf
        requiring grad."""
        actor = nets.init_arch_policy(self.gen, cfg, ACT_DIM)
        critics = nets.init_arch_ensemble_q(self.gen, cfg, ACT_DIM)
        return tree_map(lambda a: a.to(self.device).requires_grad_(),
                        (actor, critics))

    def task(self, cfg):
        """-> (tokens (BATCH, SEQ) int64, target (BATCH, ACT_DIM) in
        (-1, 1))."""
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                               generator=self.gen)
        target = torch.tanh(torch.randn((BATCH, ACT_DIM),
                                        generator=self.gen))
        return tokens.to(self.device), target.to(self.device)

    def step(self, i: int):
        """Step ``i``'s draws -> (near noise (BATCH, ACT_DIM), far
        pre-actions (BATCH, ACT_DIM), each row's coin (BATCH, 1) bool: the
        near action where true)."""
        shape = (BATCH, ACT_DIM)
        near = torch.randn(shape, generator=self.gen)
        far = torch.randn(shape, generator=self.gen)
        coin = torch.rand((BATCH, 1), generator=self.gen) < 0.5
        return tuple(a.to(self.device) for a in (near, far, coin))


def make_step(cfg, tokens, target, opt):
    """-> ``step(actor, critics, opt_actor, opt_critics, near, far, coin,
    do_actor) -> (critic_loss, actor_loss)``, updating the towers and
    their Adam states in place: the critics' step, then (under
    ``do_actor``) the actor's against the updated critics. The actor's
    forward runs once a step and serves both its actions and its loss
    (its parameters do not change in between)."""
    f32 = torch.float32

    def reward(a):
        return -((a - target) ** 2).sum(-1)

    def step(actor, critics, oa, oq, near, far, coin, do_actor):
        with torch.set_grad_enabled(do_actor):
            mean, _ = nets.arch_policy_dist(actor, tokens, cfg, dtype=f32)
        a_seen = torch.where(coin, torch.tanh(mean.detach() + EXPLORE * near),
                             torch.tanh(far))
        q = nets.arch_ensemble_q_values(critics, tokens, a_seen, cfg,
                                        dtype=f32)
        critic_loss = torch.mean((q - reward(a_seen)[None]) ** 2)
        opt.update(tower_grads(critic_loss, critics), oq, critics)
        actor_loss = -torch.mean(nets.arch_min_q_of_action(
            critics, tokens, torch.tanh(mean), cfg, dtype=f32))
        if do_actor:
            opt.update(tower_grads(actor_loss, actor), oa, actor)
        return critic_loss.detach(), actor_loss.detach()

    return step, reward


def mean_reward(actor, cfg, tokens, reward) -> float:
    with torch.no_grad():
        mean, _ = nets.arch_policy_dist(actor, tokens, cfg,
                                        dtype=torch.float32)
    return float(torch.mean(reward(torch.tanh(mean))))


def run(device="cuda", draws=None, log=print, steps=STEPS):
    """The example's loop of ``steps`` steps -> {"reward0", "final",
    "critic_losses", "actor_losses"} (the losses of the printed steps) and
    "warmup_critic_losses" (the critic loss of every warm-up step, read
    back once, after the loop). ``draws`` replaces the generator's towers
    and draws (``Draws(SEED, device)``)."""
    dev = resolve_device(device)
    cfg = example_config()
    draws = draws or Draws(SEED, dev)
    actor, critics = draws.towers(cfg)
    tokens, target = draws.task(cfg)
    opt = make_optimizer("adam", LR)
    oa, oq = opt.init(actor), opt.init(critics)
    step, reward = make_step(cfg, tokens, target, opt)

    reward0 = mean_reward(actor, cfg, tokens, reward)
    log(f"initial mean reward: {reward0:.4f}")
    out = {"reward0": reward0, "critic_losses": [], "actor_losses": []}
    warmup = []
    for i in range(steps):
        cl, al = step(actor, critics, oa, oq, *draws.step(i),
                      do_actor=i >= WARMUP)
        if i < WARMUP:
            warmup.append(cl)
        if i % PRINT_EVERY == 0:
            r = mean_reward(actor, cfg, tokens, reward)
            out["critic_losses"].append(float(cl))
            out["actor_losses"].append(float(al))
            log(f"step {i:3d}  critic_loss={float(cl):8.4f}  "
                f"actor_loss={float(al):8.4f}  reward={r:8.4f}")
    out["warmup_critic_losses"] = torch.stack(warmup).tolist()
    out["final"] = mean_reward(actor, cfg, tokens, reward)
    log(f"\nfinal mean reward: {out['final']:.4f} (0 is optimal, "
        f"initial {reward0:.4f})")
    return out


def warmup_check(critic_losses, span=CHECK_SPAN):
    """The example's check on the critic losses of the ``WARMUP`` warm-up
    steps (the actor held, the critics regressing onto the rewards): the
    mean of the last ``span`` below the mean of the first ``span``. ->
    (first mean, last mean, holds)."""
    if len(critic_losses) < WARMUP:
        raise ValueError(f"{len(critic_losses)} warm-up losses, need "
                         f"{WARMUP}")
    first = sum(critic_losses[:span]) / span
    last = sum(critic_losses[WARMUP - span:WARMUP]) / span
    return first, last, last < first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev))
    out = run(dev)
    first, last, holds = warmup_check(out["warmup_critic_losses"])
    print(f"warm-up critic loss: first {CHECK_SPAN} steps {first:.4f}, "
          f"last {CHECK_SPAN} {last:.4f}; reward gain "
          f"{out['final'] - out['reward0']:+.4f}")
    assert holds, "the critics did not learn during the warm-up"
    return 0


if __name__ == "__main__":
    main()
