"""Flash attention: online-softmax GQA attention over a whole sequence,
with causal, prefix, sliding-window and tail masks, q aligned to the end
of k.

Counterpart of ``repro/kernels/flash_attention.py:flash_attention`` and of
its oracle ``repro/kernels/ref.py:attention_ref``. ``flash_attention``
launches the CUDA kernel (``csrc/flash_attention.cu``) and only that: a
tensor that is not on a CUDA device is refused. bf16 operands run on the
tensor cores: bf16 products summed in float32, with the float32
probabilities split into two bf16 parts (~16 bits) for the P V product.
float32 operands run a float32 SIMT kernel. ``attention_ref`` is the
plain PyTorch version, in float32 (``kernels.ops`` picks between the two
by the operand's device). Both return q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand
from repro_torch.kernels._build import load_kernels

NEG_INF = -1e30


def _dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, H, d) and "
                         f"k, v {tuple(k.shape)}, {tuple(v.shape)} "
                         "(B, Sk, KV, d)")
    B, Sq, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not pair: H must be a multiple of KV")
    return B, Sq, H, d, k.shape[1], k.shape[2]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d); H % KV == 0 (the binding
    enforces the kernel's limits, prefix_len in [0, Sk] among them).
    Query i sits at position Sk - Sq + i; scores are scaled by d**-0.5.
    Under ``causal``, keys below ``prefix_len`` are visible to every query
    (the reference's ``make_mask``: the VLM's patch prefix). Returns
    (B, Sq, H, d)."""
    d = _dims(q, k, v)[3]
    check_cuda_operand(q, "q")
    check_cuda_operand(k, "k", q.dtype)
    check_cuda_operand(v, "v", q.dtype)
    out = torch.empty_like(q)
    load_kernels()
    torch.ops.repro_torch.flash_attention(q, k, v, out, causal, window,
                                          prefix_len, d ** -0.5)
    LAUNCH_COUNTS["flash_attention"] += 1
    return out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: Optional[int] = None) -> torch.Tensor:
    """Plain masked GQA attention in float32 (no blocking, no online
    softmax); the heads stay grouped (KV, G) so KV is never repeated.
    Masked probabilities are zeroed after the softmax, as the kernels do
    (``p = where(mask, p, 0)``): a query row that sees no key gives zeros,
    where ``ref.py``'s softmax alone would average the masked values."""
    B, Sq, H, d, Sk, KV = _dims(q, k, v)
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        seen = qpos[:, None] >= kpos[None, :]
        if prefix_len is not None:
            seen |= kpos[None, :] < prefix_len
        mask &= seen
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, d).to(q.dtype)
