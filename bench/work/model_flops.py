"""Model FLOPs of the benchmark's two step kinds, counted from the
configuration's widths alone: the matrix products a step needs, not what
the program happens to compute (a recomputed forward is not counted).

``backbone_flops`` is a frozen copy of
``repro_torch.launch.analysis.backbone_flops``; ``mlp_forward_flops`` and
``sac_update_flops_per_sample`` count the SAC update of the MLP towers.
"""
from __future__ import annotations

from typing import Sequence

from bench.work.kernel_work import visible_pairs


def backbone_flops(layers: int, d: int, heads: int, kv_heads: int,
                   head_dim: int, d_ff: int, B: int, S: int) -> float:
    """One forward of a dense (llama-style) backbone at (B, S), no LM
    head: 2 a weight a token for the projections and the SwiGLU MLP, and
    4 d a visible (query, key) pair a head for the causal scores and the
    weighted sum."""
    weights = (d * heads * head_dim + 2 * d * kv_heads * head_dim
               + heads * head_dim * d + 3 * d * d_ff)
    pairs = visible_pairs(S, S)
    return layers * (2 * weights * B * S + 4 * B * heads * head_dim * pairs)


def mlp_forward_flops(dims: Sequence[int]) -> float:
    """One sample through an MLP of widths ``dims`` (in, hidden..., out):
    2 FLOPs a weight."""
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def sac_update_flops_per_sample(actor_dims: Sequence[int],
                                critic_dims: Sequence[int],
                                critics: int = 2) -> float:
    """The products one SAC update needs a sample. Critic loss: the
    actor's forward on the next observation, the target critics' and the
    critics' forwards (1 + 2 critics forwards), and the critics' backward
    (weights and inputs: two forwards' worth each). Actor loss: the
    actor's and the critics' forwards on the new action, the critics'
    backward to the action only (one forward's worth each) and the
    actor's backward (two)."""
    fa, fc = mlp_forward_flops(actor_dims), mlp_forward_flops(critic_dims)
    critic_loss = fa + 2 * critics * fc + critics * 2 * fc
    actor_loss = fa + critics * fc + critics * fc + 2 * fa
    return critic_loss + actor_loss
