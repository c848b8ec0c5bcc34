"""Faults planted underneath the timed path, for the test that sees
``correct`` come out false and for the readings that set each limit's
upper end. Each is a context manager that patches the program's module
attributes and undoes the patch on leaving. The cells are training
cells on one card, so two faults apply: a step that returns its state
unchanged, and half of the batch left out with the mean taken over the
rest.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr, new):
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def _frozen(opt):
    from repro_torch.train.optimizer import Optimizer
    return Optimizer(init=opt.init, update=lambda g, s, p: (p, s))


@contextlib.contextmanager
def unchanged():
    """Every optimizer step leaves the parameters and its state as they
    were (SAC's polyak target then follows a critic that never moves)."""
    from repro_torch.rl import sac
    from repro_torch.train import optimizer
    make_opts, make_optimizer = sac.make_opts, optimizer.make_optimizer
    with _patched(sac, "make_opts",
                  lambda hp: tuple(_frozen(o) for o in make_opts(hp))), \
            _patched(optimizer, "make_optimizer",
                     lambda *a, **kw: _frozen(make_optimizer(*a, **kw))):
        yield


@contextlib.contextmanager
def half_batch():
    """The losses take the mean over the first half of the batch's rows
    only: SAC's batch means, and the arch update's losses on the first
    half of their rows."""
    from repro_torch.core import model_parallel as mp
    from repro_torch.rl import sac
    losses = mp.make_arch_spreeze_losses

    def halved(*a, **kw):
        actor_loss, critic_loss = losses(*a, **kw)

        def h(x):
            return x[:x.shape[0] // 2]

        def al(actor, q, tokens, eps):
            return actor_loss(actor, q, h(tokens), h(eps))

        def cl(q, q_target, actor, tokens, act, rew, done):
            return critic_loss(q, q_target, actor, h(tokens), h(act), h(rew),
                               h(done))
        return al, cl

    def mean_of_half(x, scale=1.0):
        return torch.mean(x[..., :x.shape[-1] // 2]) * scale
    with _patched(sac, "batch_mean", mean_of_half), \
            _patched(mp, "make_arch_spreeze_losses", halved):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
