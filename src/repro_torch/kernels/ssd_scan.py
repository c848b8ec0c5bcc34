"""Mamba-2 SSD chunked scan: per (b, h), the chunks of L rows in order,
each adding its intra-chunk term and the carried state's term to y, then
updating the (P, N) state; all in float32, y and the final state cast
back to x's dtype.

Counterpart of ``repro/kernels/ssd_scan.py:ssd_scan`` and of its oracle
``repro/kernels/ref.py:ssd_ref``. ``ssd_scan`` launches the CUDA kernels
(``csrc/ssd_scan.cu``: the chunks' own states, the state recurrence over
the chunks, then y, each pass spread over the (b, h, chunk) cells; the
binding makes the outputs and the float32 scratch) and only that: a
tensor that is not on a CUDA device is refused. ``ssd_scan_ref``
is the plain PyTorch version, the kernel's chunk loop batched over
(B, H) with torch products (``kernels.ops`` picks between the two by the
operand's device).

The chunk is ``min(chunk, S)`` and must divide S, as in the reference
(which asserts it): a 100-token prompt runs one chunk of 100, a 300-token
prompt with chunk 256 is refused. The scan starts from ``initial_state``
(B, H, P, N) when one is given, taken in float32 as the reference's
``ssd_ref`` and ``ssd_chunked`` take it, else from zero.

The backward: ``ssd_scan_bwd`` launches the backward kernels
(``csrc/ssd_scan_bwd.cu``: each chunk's own term of the state's adjoint,
the adjoint's recurrence over the chunks in reverse, the key-tile and
query-tile gradients, and the reverse cumulative sum into ``ddtA``; one
count a call) and ``ssd_scan_bwd_ref`` is its plain version, written as
the formulas. Both take the float32 states each chunk starts from, which
the forward hands back with ``return_states``. ``SSDScan`` is the
``autograd.Function`` over the two pairs, each picked by the operand's
device: the TPU kernel had no backward (the JAX package trains through
its jnp ``ssd_chunked``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import LAUNCH_COUNTS, check_cuda_operand, pick
from repro_torch.kernels._build import load_kernels


def _dims(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
          C_: torch.Tensor, chunk: int):
    """-> (B, S, H, P, N, L) with L = min(chunk, S); raises on shapes the
    reference refuses."""
    if x.dim() != 4 or B_.dim() != 4 or B_.shape != C_.shape:
        raise ValueError(f"x {tuple(x.shape)} must be (B, S, H, P) and B_, "
                         f"C_ {tuple(B_.shape)}, {tuple(C_.shape)} "
                         "(B, S, H, N)")
    Bb, S, H, P = x.shape
    if B_.shape[:3] != x.shape[:3] or dtA.shape != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)}, dtA {tuple(dtA.shape)} and "
                         f"B_ {tuple(B_.shape)} do not pair: dtA must be "
                         "(B, S, H), B_ and C_ (B, S, H, N)")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"the chunk min(chunk, S) = {L} must divide the "
                         f"sequence length S = {S} (chunk {chunk})")
    return Bb, S, H, P, B_.shape[-1], L


def _check_state(state: Optional[torch.Tensor], name: str, x: torch.Tensor,
                 N: int) -> None:
    Bb, _, H, P = x.shape
    if state is not None and state.shape != (Bb, H, P, N):
        raise ValueError(f"{name} {tuple(state.shape)} must be (B, H, P, N) "
                         f"= {(Bb, H, P, N)}")


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None,
             return_states: bool = False):
    """x: (B, S, H, P) pre-scaled by dt, float32 or bfloat16; dtA: (B, S, H)
    float32; B_/C_: (B, S, H, N) in x's dtype (groups pre-broadcast to
    heads); ``initial_state`` (B, H, P, N) of any float dtype, or None for
    zero. The kernel takes P, N <= 128 and a chunk of at most 256 (the
    binding enforces its limits). Returns (y (B, S, H, P), final_state
    (B, H, P, N)), both x's dtype, and with ``return_states`` also the
    float32 state each chunk starts from, (B, H, S / L, P, N): the
    scratch the kernels write anyway."""
    N, L = _dims(x, dtA, B_, C_, chunk)[-2:]
    _check_state(initial_state, "initial_state", x, N)
    check_cuda_operand(x, "x")
    check_cuda_operand(dtA, "dtA", torch.float32)
    check_cuda_operand(B_, "B_", x.dtype)
    check_cuda_operand(C_, "C_", x.dtype)
    if initial_state is not None:
        initial_state = initial_state.float().contiguous()
        check_cuda_operand(initial_state, "initial_state", torch.float32)
    load_kernels()
    out = torch.ops.repro_torch.ssd_scan(x, dtA, B_, C_, L, initial_state,
                                         return_states)
    LAUNCH_COUNTS["ssd_scan"] += 1
    return tuple(out)


def ssd_scan_ref(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, *, chunk: int = 64,
                 initial_state: Optional[torch.Tensor] = None,
                 return_states: bool = False):
    """Plain PyTorch version: the kernel's loop over chunks, each chunk's
    (L, L), (L, P) and (P, N) products batched over (B, H), float32."""
    Bb, S, H, P, N, L = _dims(x, dtA, B_, C_, chunk)
    _check_state(initial_state, "initial_state", x, N)
    xs, Bs, Cs = (t.float().transpose(1, 2) for t in (x, B_, C_))  # (B,H,S,·)
    As = dtA.float().transpose(1, 2)                               # (B,H,S)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    state = x.new_zeros((Bb, H, P, N), dtype=torch.float32) \
        if initial_state is None else initial_state.float()
    ys, starts = [], []
    for c0 in range(0, S, L):
        starts.append(state)
        xc, Bc, Cc = (t[:, :, c0:c0 + L] for t in (xs, Bs, Cs))
        A_cum = torch.cumsum(As[:, :, c0:c0 + L], dim=-1)          # (B,H,L)
        seg = A_cum[..., :, None] - A_cum[..., None, :]
        Lmat = torch.where(tril, torch.exp(seg), 0.0)
        G = Cc @ Bc.transpose(-1, -2)                               # (B,H,L,L)
        y = (G * Lmat) @ xc + (Cc @ state.transpose(-1, -2)) \
            * torch.exp(A_cum)[..., None]
        decay = torch.exp(A_cum[..., -1:] - A_cum)                  # (B,H,L)
        state = torch.exp(A_cum[..., -1])[..., None, None] * state \
            + xc.transpose(-1, -2) @ (Bc * decay[..., None])
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).contiguous()
    out = (y.to(x.dtype), state.to(x.dtype))
    if return_states:
        out += (torch.stack(starts, dim=2),)
    return out


def _check_bwd(x, dtA, B_, C_, states, dy, dfinal, chunk):
    Bb, S, H, P, N, L = _dims(x, dtA, B_, C_, chunk)
    if states.shape != (Bb, H, S // L, P, N):
        raise ValueError(f"states {tuple(states.shape)} must be (B, H, S / "
                         f"L, P, N) = {(Bb, H, S // L, P, N)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    _check_state(dfinal, "dfinal", x, N)
    return L


def ssd_scan_bwd(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
                 C_: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                 dfinal: Optional[torch.Tensor] = None, *, chunk: int = 64):
    """The backward of ``ssd_scan``: its operands, the float32 chunk-start
    ``states`` its forward handed back, ``dy`` like x and ``dfinal``
    (B, H, P, N) of any float dtype, or None for zero. Returns (dx, ddtA
    float32, dB, dC, dinitial float32 (B, H, P, N)), dx, dB and dC in x's
    dtype, dB and dC per head (the caller sums the heads of a group)."""
    L = _check_bwd(x, dtA, B_, C_, states, dy, dfinal, chunk)
    check_cuda_operand(x, "x")
    check_cuda_operand(dtA, "dtA", torch.float32)
    for t, name in ((B_, "B_"), (C_, "C_"), (dy, "dy")):
        check_cuda_operand(t, name, x.dtype)
    check_cuda_operand(states, "states", torch.float32)
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
        check_cuda_operand(dfinal, "dfinal", torch.float32)
    load_kernels()
    out = torch.ops.repro_torch.ssd_scan_bwd(x, dtA, B_, C_, states, dy,
                                             dfinal, L)
    LAUNCH_COUNTS["ssd_scan_bwd"] += 1
    return tuple(out)


def ssd_scan_bwd_ref(x: torch.Tensor, dtA: torch.Tensor, B_: torch.Tensor,
                     C_: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                     dfinal: Optional[torch.Tensor] = None, *,
                     chunk: int = 64):
    """Plain PyTorch version, the formulas in float32, over the chunks in
    reverse. Per chunk, with a the cumulative sum of dtA over its rows,
    a_L its last, S_c the state it starts from, W[t, s] = exp(a_t - a_s)
    for s <= t (else 0), G = C B^T, D = dy x^T and R = R_{c+1} the
    adjoint of the state it ends with (dfinal, or 0, after the last):
      R_c  = exp(a_L) R + sum_t exp(a_t) dy_t^T C_t    (dinitial = R_0)
      dx_s = sum_t (W G)[t, s] dy_t + exp(a_L - a_s) R B_s
      dB_s = sum_t (W D)[t, s] C_t + exp(a_L - a_s) R^T x_s
      dC_t = sum_s (W D)[t, s] B_s + exp(a_t) S_c^T dy_t
      da_t = rowsum_t(W G D) - colsum_t(W G D) + exp(a_t) dy_t^T S_c C_t
             - exp(a_L - a_t) x_t^T R B_t, and at t = L - 1 also
             exp(a_L) <R, S_c> + sum_s exp(a_L - a_s) x_s^T R B_s
      ddtA_s = sum_{t >= s} da_t."""
    Bb, S, H, P, N, L = _dims(x, dtA, B_, C_, chunk)
    _check_bwd(x, dtA, B_, C_, states, dy, dfinal, chunk)
    xs, Bs, Cs, dys = (t.float().transpose(1, 2) for t in (x, B_, C_, dy))
    As = dtA.float().transpose(1, 2)                               # (B,H,S)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    R = x.new_zeros((Bb, H, P, N), dtype=torch.float32) \
        if dfinal is None else dfinal.float()
    dxs, dBs, dCs, ddtAs = [], [], [], []
    for c in reversed(range(S // L)):
        rows = slice(c * L, (c + 1) * L)
        xc, Bc, Cc, dyc = (t[:, :, rows] for t in (xs, Bs, Cs, dys))
        a = torch.cumsum(As[:, :, rows], dim=-1)                   # (B,H,L)
        a_L = a[..., -1]
        S_c = states[:, :, c].float()
        W = torch.where(tril, torch.exp(a[..., :, None] - a[..., None, :]),
                        0.0)
        WG = W * (Cc @ Bc.transpose(-1, -2))                        # (B,H,L,L)
        WD = W * (dyc @ xc.transpose(-1, -2))
        e_end = torch.exp(a_L[..., None] - a)[..., None]            # (B,H,L,1)
        e_t = torch.exp(a)[..., None]
        v = e_end * (Bc @ R.transpose(-1, -2))                      # (B,H,L,P)
        w = e_t * (dyc @ S_c)                                       # (B,H,L,N)
        dxs.append(WG.transpose(-1, -2) @ dyc + v)
        dBs.append(WD.transpose(-1, -2) @ Cc + e_end * (xc @ R))
        dCs.append(WD @ Bc + w)
        WGD = WG * (dyc @ xc.transpose(-1, -2))
        q = (xc * v).sum(-1)                                        # (B,H,L)
        da = WGD.sum(-1) - WGD.sum(-2) + (Cc * w).sum(-1) - q
        da[..., -1] += torch.exp(a_L) * (R * S_c).sum((-1, -2)) + q.sum(-1)
        ddtAs.append(torch.flip(torch.cumsum(torch.flip(da, (-1,)), -1),
                                (-1,)))
        R = torch.exp(a_L)[..., None, None] * R \
            + (dyc * e_t).transpose(-1, -2) @ Cc

    def seq(parts, dtype):
        return torch.cat(parts[::-1], dim=2).transpose(1, 2).contiguous() \
            .to(dtype)
    return (seq(dxs, x.dtype), seq(ddtAs, torch.float32), seq(dBs, x.dtype),
            seq(dCs, x.dtype), R)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its backward: the kernels on a CUDA tensor, the
    plain versions on a CPU one, the meta routes on a meta one. The forward keeps the float32 chunk-start
    states that the backward's state terms read. Gradients are not
    materialised: an unused final state (training discards it) costs no
    zeros, and a given one is honoured."""

    @staticmethod
    def forward(ctx, x, dtA, B_, C_, initial_state, chunk):
        ctx.set_materialize_grads(False)
        fwd = pick(x, ssd_scan_ref, ssd_scan, "ssd_scan")
        y, final, states = fwd(x, dtA, B_, C_, chunk=chunk,
                               initial_state=initial_state,
                               return_states=True)
        ctx.save_for_backward(x, dtA, B_, C_, states)
        ctx.chunk = chunk
        ctx.init_dtype = None if initial_state is None \
            else initial_state.dtype
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dtA, B_, C_, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        bwd = pick(x, ssd_scan_bwd_ref, ssd_scan_bwd, "ssd_scan_bwd")
        with trace.span("op.ssd_scan_bwd"):
            dx, ddtA, dB, dC, dinit = bwd(x, dtA, B_, C_, states, dy,
                                          dfinal, chunk=ctx.chunk)
        dinit = None if ctx.init_dtype is None else dinit.to(ctx.init_dtype)
        return dx, ddtA, dB, dC, dinit, None
