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
by the operand's device). Both return q's dtype, and, asked for it, each
row's float32 log-sum-exp of its scaled scores (``-inf`` for a row that
sees no key).

``flash_attention_bwd`` launches the backward kernels (``csrc/
flash_attention.cu``: rowsum(dout * out), a key-tile kernel for dK and
dV, a query-tile kernel for dQ; one count a call; bf16 with head_dim up
to 128 on the tensor cores, P and dS rounded to bf16 once for their
products; float32, and bf16 above 128, in float32 on the CUDA cores) and
``flash_attention_bwd_ref`` is its plain version, written as the
formulas (P recomputed from the LSE, ``dS = P * (dP - D)``).
``FlashAttention`` is the ``autograd.Function`` over the two pairs, each
picked by the operand's device: the TPU kernel had no backward (the JAX
package trains through its jnp path).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand, pick
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
                    prefix_len: Optional[int] = None,
                    return_lse: bool = False):
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d); H % KV == 0 (the binding
    enforces the kernel's limits, prefix_len in [0, Sk] among them).
    Query i sits at position Sk - Sq + i; scores are scaled by d**-0.5.
    Under ``causal``, keys below ``prefix_len`` are visible to every query
    (the reference's ``make_mask``: the VLM's patch prefix). Returns
    (B, Sq, H, d), and with ``return_lse`` also the (B, H, Sq) float32
    log-sum-exp, which only then is written."""
    B, Sq, H, d = _dims(q, k, v)[:4]
    check_cuda_operand(q, "q")
    check_cuda_operand(k, "k", q.dtype)
    check_cuda_operand(v, "v", q.dtype)
    out = torch.empty_like(q)
    lse = q.new_empty((B, H, Sq), dtype=torch.float32) if return_lse \
        else None
    load_kernels()
    torch.ops.repro_torch.flash_attention(q, k, v, out, causal, window,
                                          prefix_len, d ** -0.5, lse)
    LAUNCH_COUNTS["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        prefix_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention`` under the same masks: ``out``
    and ``lse`` from its forward, ``dout`` like ``out``. Returns (dq like
    q, dk and dv like k), each dk and dv summed over the query heads of
    its KV head; two runs give the same bits."""
    d = _dims(q, k, v)[3]
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")):
        check_cuda_operand(t, name, None if t is q else q.dtype)
    check_cuda_operand(lse, "lse", torch.float32)
    load_kernels()
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, dout, causal, window, prefix_len, d ** -0.5)
    LAUNCH_COUNTS["flash_attention_bwd"] += 1
    return dq, dk, dv


def _mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
          prefix_len: Optional[int], device) -> torch.Tensor:
    """The (Sq, Sk) boolean mask: query i at position Sk - Sq + i."""
    qpos = (Sk - Sq) + torch.arange(Sq, device=device)
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        seen = qpos[:, None] >= kpos[None, :]
        if prefix_len is not None:
            seen |= kpos[None, :] < prefix_len
        mask &= seen
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: Optional[int] = None,
                  return_lse: bool = False):
    """Plain masked GQA attention in float32 (no blocking, no online
    softmax); the heads stay grouped (KV, G) so KV is never repeated.
    Masked probabilities are zeroed after the softmax, as the kernels do
    (``p = where(mask, p, 0)``): a query row that sees no key gives zeros,
    where ``ref.py``'s softmax alone would average the masked values.
    With ``return_lse`` also the (B, H, Sq) log-sum-exp of the visible
    scaled scores, ``-inf`` for a row that sees no key."""
    B, Sq, H, d, Sk, KV = _dims(q, k, v)
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    mask = _mask(Sq, Sk, causal, window, prefix_len, q.device)
    masked = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.softmax(masked, dim=-1), 0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(B, Sq, H, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(mask, scores, -torch.inf), dim=-1)
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            prefix_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of ``flash_attention_bwd``, in float32, as
    the formulas: P = exp(S scale - lse) where visible (0 elsewhere, so a
    row that sees no key gives zero gradients), D = rowsum(dout * out),
    dV = P^T dout, dS = P * (dout V^T - D), dQ = scale dS K, dK = scale
    dS^T Q; the heads stay grouped (KV, G)."""
    B, Sq, H, d, Sk, KV = _dims(q, k, v)
    G = H // KV
    scale = d ** -0.5
    qg = q.reshape(B, Sq, KV, G, d).float()
    dog = dout.reshape(B, Sq, KV, G, d).float()
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    mask = _mask(Sq, Sk, causal, window, prefix_len, q.device)
    lse_g = lse.reshape(B, KV, G, Sq, 1)
    p = torch.exp(torch.where(mask, scores - lse_g, -torch.inf))
    delta = (dog * out.reshape(B, Sq, KV, G, d).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]                # (B,KV,G,Sq,1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the kernels on a CUDA
    tensor, the plain versions on a CPU one, the meta routes on a meta
    one. The forward writes the LSE that the backward recomputes P
    from."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        kw = dict(causal=causal, window=window, prefix_len=prefix_len)
        fwd = pick(q, attention_ref, flash_attention, "flash_attention")
        out, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = pick(q, flash_attention_bwd_ref, flash_attention_bwd,
                   "flash_attention_bwd")
        dout = dout.contiguous()
        with trace.span("op.flash_attention_bwd"):
            dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None
