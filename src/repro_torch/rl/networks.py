"""Actor / critic towers. Counterpart of ``repro/rl/networks.py``: the
MLP towers of the paper's own setting, and (at the end) the ``arch``
towers, an LM backbone of any family read at its final position.

Weights keep the JAX layout: ``{"l<i>": {"w": (in, out), "b": (out,)}}``
with ``x @ w + b``. The double-Q ensemble stacks its two towers on a
leading axis (``w`` is (2, in, out), ``b`` is (2, out)) and evaluates
both with one batched ``torch.matmul``, where the JAX package uses
``vmap``. The actor's Gaussian noise is an argument (``eps``), never
drawn here.

On a mesh under the ``ac`` placement the ensemble is a
``PlacedEnsemble``: its towers split into parts, each part a stack on its
own device (ac row i holds towers ``[i * n/A, (i + 1) * n/A)``). The Q
functions below take either form: a placed ensemble receives the obs and
action rows on each part's device and sends back only the (B,) Q values
(paper §3.2.2, Fig. 3), and autograd carries their gradients back the
same way, so no weight and no weight gradient crosses between ac rows.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import trace
from repro_torch._tree import stack_trees, tree_leaves, tree_map, \
    unstack_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import to_group
from repro_torch.models import factory
from repro_torch.models import layers
from repro_torch.models import transformer as tf

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def dense_init(generator: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1/fan_in) weights, fan-in on the second-to-last axis."""
    return (torch.randn(shape, generator=generator, device=device)
            / math.sqrt(shape[-2]))


def init_mlp_tower(generator, in_dim: int, out_dim: int,
                   hidden: Sequence[int] = (256, 256), *, n=None,
                   device="cuda"):
    """An MLP tower; with ``n`` a stack of ``n`` towers on a leading axis."""
    dims = (in_dim,) + tuple(hidden) + (out_dim,)
    lead = () if n is None else (n,)
    return {f"l{i}": {"w": dense_init(generator,
                                      lead + (dims[i], dims[i + 1]), device),
                      "b": torch.zeros(lead + (dims[i + 1],), device=device)}
            for i in range(len(dims) - 1)}


def mlp_tower(p, x):
    """x (..., in) -> (..., out); a stacked tower maps (B, in) to
    (n, B, out) by broadcasting over its leading axis."""
    n = len(p)
    for i in range(n):
        w, b = p[f"l{i}"]["w"], p[f"l{i}"]["b"]
        x = torch.matmul(x, w) + b.unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# policy (actor)
# ---------------------------------------------------------------------------

def init_policy(generator, obs_dim: int, act_dim: int,
                hidden: Sequence[int] = (256, 256), device="cuda"):
    """Gaussian policy: outputs (mean, log_std) -> tanh squashed."""
    return init_mlp_tower(generator, obs_dim, 2 * act_dim, hidden,
                          device=device)


def policy_dist(p, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, log_std = mlp_tower(p, obs).chunk(2, dim=-1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(p, obs, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-Gaussian sample with the standard-normal draw
    ``eps`` (shaped like the action) -> (action in [-1,1], log_prob)."""
    mean, log_std = policy_dist(p, obs)
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = (-0.5 * (eps ** 2) - log_std - _HALF_LOG_2PI).sum(-1)
    # tanh change of variables
    logp = logp - torch.log(torch.clamp(1 - act ** 2, min=1e-6)).sum(-1)
    return act, logp


def deterministic_action(p, obs) -> torch.Tensor:
    mean, _ = policy_dist(p, obs)
    return torch.tanh(mean)


def det_actor_action(p, obs) -> torch.Tensor:
    """The deterministic actor of TD3 and DDPG (an ``init_mlp_tower`` of
    width act_dim): ``tanh(mlp(obs))``."""
    return torch.tanh(mlp_tower(p, obs))


# ---------------------------------------------------------------------------
# double-Q ensemble
# ---------------------------------------------------------------------------

def init_ensemble_q(generator, obs_dim: int, act_dim: int, n: int = 2,
                    hidden: Sequence[int] = (256, 256), device="cuda"):
    """``n`` Q towers stacked on a leading axis."""
    return init_mlp_tower(generator, obs_dim + act_dim, 1, hidden, n=n,
                          device=device)


class PlacedEnsemble(list):
    """A Q ensemble split over devices: a list of stacked parts (each a
    tree with leading axis n/A), part i on ac row i's device. A list, so
    the tree utilities (``tree_map``, ``tree_leaves``, Adam's moments,
    polyak averaging) walk it part by part."""


def part_leaf(part) -> torch.Tensor:
    """A part's first leaf: where (device and group) the part sits."""
    return tree_leaves(part)[0]


def _placed_q_values(towers, x: torch.Tensor, dev, home) -> torch.Tensor:
    """Q values of ``towers`` (a stack or one tower) where ``dev`` sits
    (a device or a tensor, as ``to_group`` takes it): the rows go out
    there, only the values come back to ``home``."""
    return to_group(mlp_tower(towers, to_group(x, dev))[..., 0], home)


def ensemble_q_values(stacked, obs, act) -> torch.Tensor:
    """-> (n, B) Q values of every ensemble member, on ``obs``'s device."""
    x = torch.cat([obs, act], dim=-1)
    if isinstance(stacked, PlacedEnsemble):
        return torch.cat([_placed_q_values(part, x, part_leaf(part), obs)
                          for part in stacked])
    return mlp_tower(stacked, x)[..., 0]


def tower_q_values(stacked, i: int, obs, act) -> torch.Tensor:
    """(B,) Q values of tower ``i`` alone (TD3's Q1)."""
    x = torch.cat([obs, act], dim=-1)
    if isinstance(stacked, PlacedEnsemble):
        m = tree_leaves(stacked[0])[0].shape[0]
        part = stacked[i // m]
        return _placed_q_values(tree_map(lambda w: w[i % m], part), x,
                                part_leaf(part), obs)
    return mlp_tower(tree_map(lambda w: w[i], stacked), x)[..., 0]


def min_q(stacked, obs, act) -> torch.Tensor:
    """Elementwise min over the ensemble -> (B,)."""
    return ensemble_q_values(stacked, obs, act).min(dim=0).values


# ---------------------------------------------------------------------------
# arch-backbone towers (an assigned architecture as the policy / value net)
# ---------------------------------------------------------------------------
#
# The parameters keep the reference's layout: ``{"backbone":
# factory.init_params(...), "head": ...}`` for the policy, plus
# ``"act_in"`` and ``"mix"`` for a Q tower. The double-Q ensemble stacks
# its towers' trees on a leading axis, as the reference's ``vmap``-built
# one; each tower is evaluated from its slice (``unstack_tree``), since
# the kernels take no ensemble axis. Every product runs in ``dtype``
# (bf16 by default) from the stored (float32) weights, as the
# reference's ``.astype(dtype)`` at each use.

def init_arch_policy(gen: torch.Generator, cfg: ModelConfig, act_dim: int,
                     dtype=torch.float32, device=None):
    """LM backbone + Gaussian head reading the final position's hidden, on
    ``device`` (the generator's unless given; ``meta`` builds the shapes
    only)."""
    device = device or gen.device
    return {
        "backbone": factory.init_params(cfg, gen, dtype=dtype,
                                        device=device),
        "head": {"w": layers.dense_init(gen, (cfg.d_model, 2 * act_dim),
                                        dtype=dtype, device=device),
                 "b": torch.zeros((2 * act_dim,), dtype=dtype,
                                  device=device)},
    }


def arch_policy_dist(p, tokens: torch.Tensor, cfg: ModelConfig,
                     dtype=torch.bfloat16, remat: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mean, log_std), each (B, act_dim) float32: the head in
    ``dtype``, then the cast, the split and the clip."""
    h = _backbone_hidden(p["backbone"], tokens, cfg, dtype, remat)
    out = h @ p["head"]["w"].to(dtype) + p["head"]["b"].to(dtype)
    mean, log_std = out.float().chunk(2, dim=-1)
    return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def init_arch_q(gen: torch.Generator, cfg: ModelConfig, act_dim: int,
                dtype=torch.float32, device=None):
    """Backbone + nonlinear (state, action) head: the action must interact
    with the state nonlinearly or Q degenerates to f(s) + w.a."""
    d, device = cfg.d_model, device or gen.device
    return {
        "backbone": factory.init_params(cfg, gen, dtype=dtype,
                                        device=device),
        "act_in": {"w": layers.dense_init(gen, (act_dim, d), dtype=dtype,
                                          device=device, scale=3.0)},
        "mix": {"w": layers.dense_init(gen, (d, d), dtype=dtype,
                                       device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)},
        "head": {"w": layers.dense_init(gen, (d, 1), dtype=dtype,
                                        device=device),
                 "b": torch.zeros((1,), dtype=dtype, device=device)},
    }


def init_arch_ensemble_q(gen: torch.Generator, cfg: ModelConfig,
                         act_dim: int, n: int = 2, dtype=torch.float32,
                         device=None):
    """``n`` arch Q towers stacked on a leading axis (the reference's
    ``vmap`` of ``init_arch_q``)."""
    return stack_trees([init_arch_q(gen, cfg, act_dim, dtype=dtype,
                                    device=device) for _ in range(n)])


def _arch_q_head(p, h: torch.Tensor, act: torch.Tensor, dtype
                 ) -> torch.Tensor:
    """Q from the backbone's hidden ``h`` (B, D) and the action: the action
    enters after the backbone, then ``tanh`` of the mix, then the head,
    all in ``dtype``; -> (B,) float32."""
    h = h + act.to(dtype) @ p["act_in"]["w"].to(dtype)
    h = torch.tanh(h @ p["mix"]["w"].to(dtype) + p["mix"]["b"].to(dtype))
    q = h @ p["head"]["w"].to(dtype) + p["head"]["b"].to(dtype)
    return q.float()[..., 0]


def arch_q_value(p, tokens: torch.Tensor, act: torch.Tensor,
                 cfg: ModelConfig, dtype=torch.bfloat16,
                 remat: bool = True) -> torch.Tensor:
    return _arch_q_head(p, _backbone_hidden(p["backbone"], tokens, cfg,
                                            dtype, remat), act, dtype)


def _towers(stacked):
    """The towers of a stacked ensemble, each a tree of views."""
    return unstack_tree(stacked, tree_leaves(stacked)[0].shape[0])


def arch_ensemble_q_values(stacked, tokens: torch.Tensor,
                           act: torch.Tensor, cfg: ModelConfig,
                           dtype=torch.bfloat16, remat: bool = True,
                           hidden: Optional[List[torch.Tensor]] = None
                           ) -> torch.Tensor:
    """-> (n, B) Q values of every tower of a stacked ensemble. Given a
    list ``hidden``, each tower's backbone hidden state (B, D) is appended
    to it, detached: what ``arch_min_q_of_action`` takes in place of
    running the backbones again."""
    qs = []
    for tower in _towers(stacked):
        h = _backbone_hidden(tower["backbone"], tokens, cfg, dtype, remat)
        if hidden is not None:
            hidden.append(h.detach())
        qs.append(_arch_q_head(tower, h, act, dtype))
    return torch.stack(qs)


def arch_min_q_of_action(stacked, tokens: torch.Tensor, act: torch.Tensor,
                         cfg: ModelConfig, dtype=torch.bfloat16,
                         remat: bool = True,
                         hidden: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """min over the ensemble of Q(tokens, act) -> (B,), differentiable in
    ``act`` only: the towers are held constant. The action enters after
    the backbone, so each backbone runs without a graph, and only the
    heads keep one (to carry the gradient to ``act``). Given ``hidden``,
    the towers' backbone hidden states on these tokens (as
    ``arch_ensemble_q_values`` hands them back), the backbones do not run
    at all. The value is the ensemble's min as ``arch_ensemble_q_values``
    gives it."""
    qs = []
    for i, tower in enumerate(_towers(stacked)):
        if hidden is None:
            with torch.no_grad():
                h = _backbone_hidden(tower["backbone"], tokens, cfg, dtype,
                                     remat)
        else:
            h = hidden[i]
        qs.append(_arch_q_head(tree_map(torch.Tensor.detach, tower), h,
                               act, dtype))
    return torch.stack(qs).min(dim=0).values


def _backbone_hidden(params, tokens: torch.Tensor, cfg: ModelConfig, dtype,
                     remat: bool) -> torch.Tensor:
    """Final-position hidden state of the arch backbone (no LM head), as
    the reference's: ``factory.hidden_states`` over the tokens, with
    ``encoder_seq`` zero frames for enc-dec and ``num_patch_tokens`` zero
    patches for the VLM, and no ``prefix_len``, so the VLM runs causal
    over its patches (unlike ``factory.forward``); the aux loss is
    dropped. ``ln_f`` is applied to the last position alone: a row-wise
    norm, so the same numbers as the reference's norm of every position
    read at the last. Each call is one tower forward
    (``model.backbone_forwards``)."""
    trace.count("model.backbone_forwards")
    B = tokens.shape[0]
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                      dtype=dtype, device=tokens.device)
    elif cfg.family == "vlm":
        batch["patches"] = torch.zeros((B, cfg.num_patch_tokens,
                                        cfg.d_model), dtype=dtype,
                                       device=tokens.device)
    x, _ = factory.hidden_states(params, batch, cfg, dtype=dtype,
                                 remat=remat)
    return tf.apply_norm(params["ln_f"], x[:, -1].contiguous(), cfg)
