"""The work of each hand-written kernel: the bytes it must move and the
operations it does, as plain functions of the shapes and dtypes.

One function a kernel, named as ``LAUNCH_COUNTS`` names it (rows 1-15 of
PERF.md §6). Each returns a ``Work``: the bytes (each input read once,
each output written once; no scratch), the FLOPs, the peak those FLOPs
run at (``"bf16"``: the tensor cores, for a kernel whose products take
bf16 operands; ``"f32"``: the CUDA cores) and the device launches one
wrapper call makes. ``launch.analysis.bound_ms`` turns a ``Work`` into
the least time the card could take. The census of the meta device
(``launch.analysis.OpCensus``), ``chip_smoke.py`` and ``tools/`` all
read these functions, so each kernel's work is counted in one place.

Where the work depends on the data (the distinct rows of a gather, the
valid slots of a decode cache), the caller passes what its data needs;
the default is the most a call could need. Counting rules:

- replay kernels: 4 bytes an index and a float, the pointer 4 bytes;
- ``rmsnorm``: x read and y written in x's dtype, the float32 weight
  read; 4 FLOPs an element (its backward: 10, x and dy read, dx written);
- ``rope``: q and k read and written in their dtype, the positions read;
  the 4 products and 2 sums a pair of elements (the angles' cosines and
  sines, a few a token and vector, are left out); its backward the same;
- ``flash_attention``: q read and the output written, k and v read; 4 d
  FLOPs a head for each (query, key) pair the mask lets through
  (``visible_pairs``), the backward 2.5 times that (five products
  against two), reading q, out, dout and writing dq, reading k, v and
  writing dk, dv, and reading the float32 LSE;
- ``decode_attention``: the two caches read, q read and the output
  written, the valid length read; 4 d float32 FLOPs a head and slot;
- ``ssd_scan``: x, B_, C_ read and y and the final state written in x's
  dtype, dtA read in float32; the reference's full L x L products per
  chunk and head; its backward as ``chip_smoke.time_ssd_scan_bwd`` sets
  out.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np


@dataclass(frozen=True)
class Work:
    bytes: float
    flops: float = 0.0
    flop_type: str = "f32"      # "bf16" (tensor cores) or "f32"
    launches: int = 1           # device launches of one wrapper call


def _size(dtype) -> int:
    """Bytes of an element: a ``torch.dtype``, or 2 / 4 directly."""
    return dtype if isinstance(dtype, int) else dtype.itemsize


def _mma(dtype) -> str:
    """The peak a kernel's products run at: bf16 operands go to the
    tensor cores, float32 ones to the CUDA cores."""
    return "bf16" if _size(dtype) == 2 else "f32"


# --------------------------------------------------------------------------- #
# the replay kernels (rows 1-7)
# --------------------------------------------------------------------------- #

def ring_write(rows: int, row_bytes: int) -> Work:
    """One round's write of ``rows`` rows of ``row_bytes`` (all the
    fields' bytes a row): the batch read once, the rows written once, the
    pointer read once."""
    return Work(bytes=2 * rows * row_bytes + 4)


def ring_gather(batch: int, row_bytes: int,
                distinct: Optional[int] = None) -> Work:
    """One update's gather of ``batch`` indices: the indices read once,
    each of the ``distinct`` source rows read once (every index by
    default), the output written once."""
    distinct = batch if distinct is None else distinct
    return Work(bytes=batch * 4 + distinct * row_bytes + batch * row_bytes)


def per_scores(rows: int) -> Work:
    """Both (rows,) vectors read once, the scores written once; a log, a
    product and a sum a row."""
    return Work(bytes=3 * rows * 4, flops=3 * rows)


def per_topk(rows: int, k: int) -> Work:
    """Both vectors read once, k scores and k indices written once: three
    device launches a call (the scores' histogram, the threshold, the
    sorted selection)."""
    return Work(bytes=2 * rows * 4 + k * 8, flops=3 * rows, launches=3)


def priority_scatter(k: int, distinct: Optional[int] = None) -> Work:
    """Indices and values read once, each distinct row written once."""
    distinct = k if distinct is None else distinct
    return Work(bytes=k * 8 + distinct * 4)


ring_write_rowloop = ring_write
ring_gather_rowloop = ring_gather


# --------------------------------------------------------------------------- #
# the model kernels (rows 8-15)
# --------------------------------------------------------------------------- #

def rmsnorm(rows: int, dim: int, dtype) -> Work:
    return Work(bytes=2 * rows * dim * _size(dtype) + dim * 4,
                flops=4 * rows * dim)


def rmsnorm_bwd(rows: int, dim: int, dtype) -> Work:
    """Two launches: dx with each block's partial dw, then their sum."""
    return Work(bytes=3 * rows * dim * _size(dtype) + 2 * dim * 4,
                flops=10 * rows * dim, launches=2)


def rope(B: int, Sq: int, Sk: int, H: int, KV: int, d: int, dtype,
         pos_size: int = 8) -> Work:
    """q (B, Sq, H, d) and k (B, Sk, KV, d) (Sk = KV = 0: no k), read
    once and written once, the positions (Sq,) and (Sk,) of ``pos_size``
    bytes read once; 3 FLOPs an element."""
    elems = B * Sq * H * d + B * Sk * KV * d
    return Work(bytes=2 * elems * _size(dtype) + (Sq + Sk) * pos_size,
                flops=3 * elems)


rope_bwd = rope


def visible_pairs(Sq: int, Sk: int, causal: bool = True,
                  window: Optional[int] = None,
                  prefix_len: Optional[int] = None) -> int:
    """The (query, key) pairs the mask lets through: query i sits at
    position Sk - Sq + i and sees the keys [lo, hi) (the reference's
    ``make_mask``)."""
    pos = np.arange(Sk - Sq, Sk, dtype=np.int64)
    hi = np.full_like(pos, Sk)
    if causal:
        hi = np.minimum(np.maximum(pos + 1, prefix_len or 0), Sk)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(B: int, Sq: int, Sk: int, H: int, KV: int, d: int,
                    dtype, *, causal: bool = True,
                    window: Optional[int] = None,
                    prefix_len: Optional[int] = None,
                    lse: bool = False) -> Work:
    """q (B, Sq, H, d), k and v (B, Sk, KV, d); ``lse``: the float32
    (B, H, Sq) log-sum-exp is written too (a training forward)."""
    nbytes = (2 * B * Sq * H * d + 2 * B * Sk * KV * d) * _size(dtype)
    if lse:
        nbytes += B * H * Sq * 4
    pairs = visible_pairs(Sq, Sk, causal, window, prefix_len)
    return Work(bytes=nbytes, flops=4 * B * H * d * pairs,
                flop_type=_mma(dtype))


def flash_attention_bwd(B: int, Sq: int, Sk: int, H: int, KV: int, d: int,
                        dtype, *, causal: bool = True,
                        window: Optional[int] = None,
                        prefix_len: Optional[int] = None) -> Work:
    """Three launches: rowsum(dout * out), the key tiles (dK, dV), the
    query tiles (dQ)."""
    nbytes = (4 * B * Sq * H * d + 4 * B * Sk * KV * d) * _size(dtype) \
        + B * H * Sq * 4
    pairs = visible_pairs(Sq, Sk, causal, window, prefix_len)
    return Work(bytes=nbytes, flops=10 * B * H * d * pairs,
                flop_type=_mma(dtype), launches=3)


def decode_attention(B: int, S: int, H: int, KV: int, d: int, dtype,
                     valid: Optional[int] = None) -> Work:
    """One query a (b, h) against (B, S, KV, d) caches, of which ``valid``
    slots attend (all of them by default): the float32 FLOPs over the
    float32 peak. Two launches: the split-K pass and the combine."""
    valid = S if valid is None else min(valid, S)
    it = _size(dtype)
    return Work(bytes=2 * B * valid * KV * d * it + 2 * B * H * d * it + 4,
                flops=4 * B * H * d * valid, flop_type="f32", launches=2)


def ssd_scan(B: int, S: int, H: int, P: int, N: int, chunk: int, dtype, *,
             initial_state: bool = False, states: bool = False) -> Work:
    """x (B, S, H, P), dtA (B, S, H), B_ and C_ (B, S, H, N), chunks of
    L = min(chunk, S); ``initial_state``: a float32 (B, H, P, N) read;
    ``states``: the float32 chunk-start states handed back (a training
    forward). Three launches: the chunks' own states, the recurrence,
    y."""
    L = min(chunk, S)
    nc = S // L
    nbytes = _size(dtype) * (2 * B * S * H * P + 2 * B * S * H * N
                             + B * H * P * N) + 4 * B * S * H
    if initial_state:
        nbytes += 4 * B * H * P * N
    if states:
        nbytes += 4 * B * H * nc * P * N
    flops = B * H * nc * 2 * (L * L * N + L * L * P + 2 * L * P * N)
    return Work(bytes=nbytes, flops=flops, flop_type=_mma(dtype),
                launches=3)


def ssd_scan_bwd(B: int, S: int, H: int, P: int, N: int, chunk: int,
                 dtype) -> Work:
    """x, dy, B_, C_, the float32 chunk states and dtA read once; dx, dB,
    dC and ddtA written once; per chunk and head the L x L products and
    the state products (``chip_smoke.time_ssd_scan_bwd``). Five
    launches."""
    L = min(chunk, S)
    nc = S // L
    nbytes = _size(dtype) * (3 * B * S * H * P + 4 * B * S * H * N) \
        + 4 * (B * H * nc * P * N + 2 * B * S * H)
    flops = 2 * B * H * nc * (L * L * (3 * N + 2 * P) + 4 * L * P * N)
    return Work(bytes=nbytes, flops=flops, flop_type=_mma(dtype),
                launches=5)


KERNELS = ("ring_write", "ring_gather", "per_scores", "per_topk",
           "priority_scatter", "ring_write_rowloop", "ring_gather_rowloop",
           "rmsnorm", "flash_attention", "decode_attention", "ssd_scan",
           "rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd", "rope",
           "rope_bwd")


# --------------------------------------------------------------------------- #
# where a meta route reports its call
# --------------------------------------------------------------------------- #

_SINKS: List = []


@contextlib.contextmanager
def recording(sink) -> Iterator:
    """Route every meta kernel call to ``sink.kernel(name, work)`` while
    the block runs (``launch.analysis.OpCensus`` enters it)."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def record(name: str, work: Work) -> None:
    """A meta route's call of kernel ``name``: one wrapper call, in
    ``LAUNCH_COUNTS``' unit, told to the innermost recording sink."""
    if _SINKS:
        _SINKS[-1].kernel(name, work)
