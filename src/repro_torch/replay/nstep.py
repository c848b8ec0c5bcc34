"""n-step return transform over sampler chunks (APE-X-style).
Counterpart of ``repro/replay/nstep.py``.

Operates on a chunk of stacked transitions (T, N, ...): row t becomes

  rew'      = sum_{i=0..k-1} gamma^i r[t+i]
  next_obs' = next_obs[t+k-1]
  disc'     = gamma^k * (1 - done[t+k-1])

where k <= n stops at episode ends (done) or at the chunk boundary: a
tail row becomes a k-step transition with k < n. That truncation also
holds for n - 1 > T, where every look-ahead past the chunk is empty.
"""
from __future__ import annotations

from typing import Dict

import torch


def _shift(a: torch.Tensor, i: int) -> torch.Tensor:
    """a[t+i] with zero padding past the chunk end (same length T)."""
    out = torch.zeros_like(a)
    if i < a.shape[0]:
        out[:a.shape[0] - i] = a[i:]
    return out


def nstep_chunk(exps: Dict[str, torch.Tensor], n: int, gamma: float
                ) -> Dict[str, torch.Tensor]:
    """exps: {obs, act, rew, next_obs, done} each (T, N, ...) -> same keys
    + "disc", with n-step returns. n=1 just adds disc = gamma*(1-done)."""
    rew, done, nxt = exps["rew"], exps["done"], exps["next_obs"]
    T = rew.shape[0]
    steps = torch.arange(T, device=rew.device)

    R = rew
    cont = 1.0 - done                       # still accumulating after t+0
    new_next = nxt
    disc = gamma * cont
    for i in range(1, n):
        valid = (steps + i < T).to(rew.dtype)
        take = cont * valid.reshape((T,) + (1,) * (rew.dim() - 1))
        d_i = _shift(done, i)
        R = R + (gamma ** i) * take * _shift(rew, i)
        mask = take.reshape(take.shape + (1,) * (nxt.dim() - take.dim()))
        new_next = torch.where(mask > 0, _shift(nxt, i), new_next)
        disc = torch.where(take > 0, (gamma ** (i + 1)) * (1.0 - d_i), disc)
        cont = take * (1.0 - d_i)

    out = dict(exps)
    out["rew"] = R
    out["next_obs"] = new_next
    out["disc"] = disc
    return out
