"""Model factory: init / prefill / decode for every family.

Counterpart of ``repro/models/factory.py`` for the dense, MoE (mixtral,
kimi-k2), enc-dec (whisper: a LayerNorm encoder over stubbed frame
embeddings, and a decoder with learned positions and cross attention),
ssm (mamba2), VLM (paligemma: stubbed patch embeddings prepended to the
text, which every text token sees) and hybrid (zamba2: mamba2 core
layers and one shared-weight attention block run before every
``hybrid_attn_every`` of them) families, and the port's own interleaved
family (granite-4.0-h-micro: ``InterleavedConfig.layer_types`` over a
stack of Mamba-2 layers and a stack of attention layers, each layer with
its own MLP; the embedding, residual and logit multipliers; no serving
path):

  init_params(cfg, gen)                          -> param tree (f32)
  cast_params(params, dtype)                     -> the same, cast for compute
  init_cache(cfg, batch, seq_len)                -> stacked cache tree
  prefill(params, batch, cfg, seq_len)           -> (cache, last_logits)
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params_analytic(cfg, active_only)        -> int
  hidden_states(params, batch, cfg, remat,
                prefix_len)                      -> (last layer's output, aux)
  forward(params, batch, cfg, remat)             -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat)             -> (loss, {"ce", "aux"})

``forward`` and ``loss_fn`` train every family on the card: every kernel
they reach has a backward kernel (rmsnorm, flash attention, the SSD
scan). The hybrid runs its shared block before each group of core
layers, not checkpointed, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._tree import stack_trees, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cross_entropy, embed_init

WHISPER_DEC_MAX_POS = 32768   # sized for the decode_32k shape

_KIND = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
         "hybrid": "ssm", "encdec": "dec", "interleaved": None}


def _layer_kind(cfg: ModelConfig) -> Optional[str]:
    """The family's one layer kind (None for the interleaved family,
    whose layers follow ``layer_types``)."""
    if cfg.family not in _KIND:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); "
                         f"known: {sorted(_KIND)}")
    return _KIND[cfg.family]


def _no_serving(cfg: ModelConfig) -> None:
    if cfg.family == "interleaved":
        raise NotImplementedError(
            f"{cfg.name}: the interleaved family has no serving path "
            "(cache, prefill, decode); it trains through forward and "
            "loss_fn")


def _interleaved_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(Mamba-2 layers, attention layers) of ``layer_types``."""
    n = sum(t == "mamba" for t in cfg.layer_types)
    return n, cfg.num_layers - n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``gen`` on ``device`` (the generator's device
    unless given; ``meta`` builds the shapes only). The norms and the MoE
    router are float32 whatever ``dtype`` is, as the reference's; every
    other leaf is drawn in float32 and cast to ``dtype`` (the same
    numbers as a float32 init cast afterwards)."""
    kind = _layer_kind(cfg)
    device = device or gen.device
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                            device=device),
        "ln_f": tf.init_norm(cfg, device=device),
    }
    if cfg.family == "interleaved":
        n_mamba, n_attn = _interleaved_counts(cfg)
        p["layers"] = {
            "mamba": tf.init_stack(gen, cfg, n_mamba, kind="mamba",
                                   dtype=dtype, device=device),
            "attn": tf.init_stack(gen, cfg, n_attn, kind="dense",
                                  dtype=dtype, device=device)}
    else:
        p["layers"] = tf.init_stack(gen, cfg, cfg.num_layers, kind=kind,
                                    dtype=dtype, device=device)
    if cfg.family == "hybrid":
        p["shared_attn"] = tf.init_layer(gen, cfg, kind="dense", dtype=dtype,
                                         device=device)
    if cfg.family == "encdec":
        p["enc_layers"] = tf.init_stack(gen, cfg, cfg.encoder_layers,
                                        kind="enc", dtype=dtype,
                                        device=device)
        p["enc_ln_f"] = tf.init_norm(cfg, device=device)
        p["dec_pos"] = torch.randn(
            (WHISPER_DEC_MAX_POS, cfg.d_model), generator=gen,
            device=device).mul_(0.01).to(dtype)
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                               device=device)
    return p


# Kept in float32: the norm weights (the rmsnorm kernel's float32 weight;
# the LayerNorm's weight and bias, which the reference applies in float32),
# and the SSM's decay parameters, which the reference uses in float32
# arithmetic (``dt_bias``, ``A_log``; ``D_skip`` it casts at its use, as
# the port). The MoE router, stored in float32, is multiplied in the
# compute dtype (``moe.py:134``), so it is cast like any other weight.
_FLOAT32 = ("ln1", "ln2", "ln3", "ln_f", "enc_ln_f", "norm_w", "A_log",
            "dt_bias")


def cast_params(params, dtype: torch.dtype):
    """Every weight cast to the compute dtype once, the norms and the SSM
    decay parameters kept in float32: the same numbers as the reference's
    cast at each use (``.astype(dtype)``), without repeating the cast
    every step."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: (v if k in _FLOAT32 else cast(v))
                    for k, v in tree.items()}
        return tree.to(dtype)
    return cast(params)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows in ``dtype``, times the interleaved family's
    ``embedding_multiplier``."""
    x = params["embed"][tokens].to(dtype)
    if cfg.family == "interleaved":
        x = x * cfg.embedding_multiplier
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig,
            dtype: torch.dtype) -> torch.Tensor:
    """The final norm and the (tied) head; the interleaved family's
    logits over ``logits_scaling``."""
    x = tf.apply_norm(params["ln_f"], x, cfg)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = x @ table.to(dtype).T
    if cfg.family == "interleaved":
        logits = logits / cfg.logits_scaling
    return logits


def _sinusoid(S: int, D: int, dtype: torch.dtype, device=None
              ) -> torch.Tensor:
    """(S, D) sinusoidal positions: sin of the first D/2, cos of the rest."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def _encode(params, frames: torch.Tensor, cfg: ModelConfig,
            dtype: torch.dtype, remat: bool = False) -> torch.Tensor:
    """Whisper encoder over stubbed (B, S_enc, D) frame embeddings, each
    layer checkpointed under ``remat`` (training)."""
    S = frames.shape[1]
    x = frames.to(dtype) + _sinusoid(S, cfg.d_model, dtype, frames.device)
    pos = torch.arange(S, device=frames.device)
    x, _ = tf.stack_forward(params["enc_layers"], x, cfg, kind="enc",
                            positions=pos, dtype=dtype, remat=remat)
    return tf.apply_norm(params["enc_ln_f"], x, cfg)


def _hybrid_groups(cfg: ModelConfig):
    """The hybrid's (start, end) core-layer slices; the shared attention
    block runs before each. The last may be shorter."""
    k = cfg.hybrid_attn_every
    return [(s, min(s + k, cfg.num_layers))
            for s in range(0, cfg.num_layers, k)]


def _slice_layers(stacked, s: int, e: int):
    """Layers [s, e) of a stacked tree, as views."""
    return tree_map(lambda a: a[s:e], stacked)


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------

def hidden_states(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  *, dtype=torch.bfloat16, remat: bool = True,
                  prefix_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backbone's walk -> (the last layer's output (B, S, D) at every
    position, before ``ln_f``; the aux loss, None for the interleaved and
    hybrid families, which have none). ``batch`` holds tokens (and frames
    or patches, prepended to the text); ``prefix_len`` makes the VLM's
    first positions see each other (``tf.stack_forward``)."""
    kind = _layer_kind(cfg)
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        memory = _encode(params, batch["frames"], cfg, dtype, remat)
    x = _embed(params, tokens, cfg, dtype)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "encdec":
        x = x + params["dec_pos"][:tokens.shape[1]].to(dtype)
        return tf.stack_forward(params["layers"], x, cfg, kind="dec",
                                positions=pos, memory=memory, dtype=dtype,
                                remat=remat)
    if cfg.family == "interleaved":
        return tf.interleaved_forward(params["layers"], x, cfg,
                                      positions=pos, dtype=dtype,
                                      remat=remat), None
    if cfg.family == "hybrid":
        for s, e in _hybrid_groups(cfg):
            x, _, _ = tf.layer_forward(params["shared_attn"], x, cfg,
                                       kind="dense", positions=pos,
                                       dtype=dtype)
            x, _ = tf.stack_forward(_slice_layers(params["layers"], s, e),
                                    x, cfg, kind="ssm", positions=pos,
                                    dtype=dtype, remat=remat)
        return x, None
    return tf.stack_forward(params["layers"], x, cfg, kind=kind,
                            positions=pos, prefix_len=prefix_len,
                            dtype=dtype, remat=remat)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux_loss). ``batch`` holds tokens (and
    frames or patches); the VLM's logits cover its patch prefix too,
    which every text token sees."""
    prefix = cfg.num_patch_tokens if cfg.family == "vlm" else None
    x, aux = hidden_states(params, batch, cfg, dtype=dtype, remat=remat,
                           prefix_len=prefix)
    logits = _logits(params, x, cfg, dtype)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ the MoE aux loss). The targets are the tokens
    rolled by one with the last position masked, as the reference; the
    VLM's text logits sit after its P patches."""
    logits, aux = forward(params, batch, cfg, dtype=dtype, remat=remat)
    tokens = batch["tokens"]
    B, S_text = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    mask = (torch.arange(S_text, device=tokens.device) < S_text - 1).float()
    mask = mask.expand(B, S_text)
    if cfg.family == "vlm":
        P = cfg.num_patch_tokens
        logits = logits[:, P:P + S_text]
    ce = cross_entropy(logits, targets, mask)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None):
    """``seq_len`` sizes the attention caches (the VLM's counts its patch
    prefix); enc-dec adds the encoder memory's cross-attention cache."""
    _no_serving(cfg)
    kind = _layer_kind(cfg)
    if cfg.family == "hybrid":
        core = tf.init_layer_cache(cfg, cfg.num_layers, batch, seq_len,
                                   kind="ssm", dtype=dtype, device=device)
        shape = (len(_hybrid_groups(cfg)), batch,
                 attn_lib.cache_len_for(cfg, seq_len), cfg.num_kv_heads,
                 cfg.head_dim)
        return {"core": core,
                "shared": {"k": torch.zeros(shape, dtype=dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=device)}}
    mem = cfg.encoder_seq if cfg.family == "encdec" else 0
    return tf.init_layer_cache(cfg, cfg.num_layers, batch, seq_len,
                               kind=kind, dtype=dtype, device=device,
                               memory_len=mem)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            seq_len: int, *, dtype=torch.bfloat16) -> Tuple[Any, torch.Tensor]:
    """Process a full prompt; returns (cache, logits of the final position).
    ``batch`` holds ``tokens`` (B, S), and ``frames`` (enc-dec) or
    ``patches`` (VLM). ``seq_len`` sizes the attention caches: when it is
    shorter than the sequence (the VLM's patches count), only the last
    ``seq_len`` keys are kept, as the reference's ring."""
    _no_serving(cfg)
    kind = _layer_kind(cfg)
    tokens = batch["tokens"]
    ring = attn_lib.cache_len_for(cfg, seq_len)
    memory = None
    prefix_len = None
    x = _embed(params, tokens, cfg, dtype)
    if cfg.family == "encdec":
        memory = _encode(params, batch["frames"], cfg, dtype)
        x = x + params["dec_pos"][:tokens.shape[1]].to(dtype)
    elif cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
        prefix_len = cfg.num_patch_tokens
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    if cfg.family == "hybrid":
        core, shared = [], []
        for s, e in _hybrid_groups(cfg):
            x, sc = tf.layer_prefill(params["shared_attn"], x, cfg,
                                     kind="dense", positions=pos,
                                     dtype=dtype, ring_len=ring, seq_len=S)
            shared.append(sc)
            x, cc = tf.stack_prefill(_slice_layers(params["layers"], s, e),
                                     x, cfg, kind="ssm", positions=pos,
                                     dtype=dtype, ring_len=ring, seq_len=S)
            core.append(cc)
        cache = {"core": {k: torch.cat([c[k] for c in core])
                          for k in core[0]},
                 "shared": stack_trees(shared)}
    else:
        x, cache = tf.stack_prefill(params["layers"], x, cfg, kind=kind,
                                    positions=pos, prefix_len=prefix_len,
                                    memory=memory, dtype=dtype,
                                    ring_len=ring, seq_len=S)
    return cache, _logits(params, x[:, -1:].contiguous(), cfg, dtype)


def decode_step(params, token: torch.Tensor, cache, cache_pos: torch.Tensor,
                cfg: ModelConfig, *, dtype=torch.bfloat16,
                memory_len: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token: (B,1) int; cache_pos: int32 scalar tensor on
    the model's device, the absolute position of this token (the VLM's
    counts its patch prefix). enc-dec: ``memory_len``, an int32 scalar
    tensor on that device, the valid slots of the memory's cache (all of
    them when not given; a caller that steps many times makes it once).
    The cache is updated in place and returned."""
    _no_serving(cfg)
    kind = _layer_kind(cfg)
    x = _embed(params, token, cfg, dtype)
    if cfg.family == "encdec":
        # the learned position by a device index: no read back to the host
        x = x + torch.index_select(params["dec_pos"], 0,
                                   cache_pos.reshape(1).long()).to(dtype)
        x, cache = tf.stack_decode(params["layers"], x, cache, cache_pos,
                                   cfg, kind=kind, memory_len=memory_len,
                                   dtype=dtype)
    elif cfg.family == "hybrid":
        for gi, (s, e) in enumerate(_hybrid_groups(cfg)):
            sc = {"k": cache["shared"]["k"][gi],
                  "v": cache["shared"]["v"][gi]}
            x, _ = tf.layer_decode(params["shared_attn"], x, sc, cache_pos,
                                   cfg, kind="dense", dtype=dtype)
            x, _ = tf.stack_decode(_slice_layers(params["layers"], s, e), x,
                                   _slice_layers(cache["core"], s, e),
                                   cache_pos, cfg, kind="ssm", dtype=dtype)
    else:
        x, cache = tf.stack_decode(params["layers"], x, cache, cache_pos,
                                   cfg, kind=kind, dtype=dtype)
    return _logits(params, x, cfg, dtype), cache


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        n += h * hd + 2 * kv * hd
    return n


def _ssm_params(cfg: ModelConfig) -> int:
    d_inner, H, conv_ch, d_in_proj = ssm_lib.ssm_dims(cfg)
    return (cfg.d_model * d_in_proj + cfg.ssm.conv_dim * conv_ch + conv_ch
            + 3 * H + d_inner + d_inner * cfg.d_model)


def _norm_params(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model if cfg.family == "encdec" else cfg.d_model


def count_params_analytic(cfg: ModelConfig, active_only: bool = False
                          ) -> int:
    """The parameters ``init_params`` builds; ``active_only`` counts the
    experts a token runs (MoE: k of E, the shared ones, the router)."""
    _layer_kind(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    norm = _norm_params(cfg)
    total = V * D + norm
    if not cfg.tie_embeddings:
        total += V * D
    dense = _attn_params(cfg) + 2 * norm + 3 * D * cfg.d_ff
    if cfg.family in ("dense", "vlm"):
        total += cfg.num_layers * dense
    elif cfg.family == "moe":
        m = cfg.moe
        e = m.experts_per_token if active_only else m.num_experts
        per = (_attn_params(cfg) + 2 * norm + D * m.num_experts
               + 3 * e * D * m.expert_d_ff
               + 3 * m.num_shared_experts * D * m.expert_d_ff)
        total += cfg.num_layers * per
    elif cfg.family in ("ssm", "hybrid"):
        total += cfg.num_layers * (_ssm_params(cfg) + norm)
        if cfg.family == "hybrid":
            total += dense
    elif cfg.family == "interleaved":
        n_mamba, n_attn = _interleaved_counts(cfg)
        total += (n_mamba * (_ssm_params(cfg) + 2 * norm + 3 * D * cfg.d_ff)
                  + n_attn * dense)
    else:                                                  # encdec
        enc_mlp = 2 * D * cfg.d_ff + cfg.d_ff + D
        enc_per = _attn_params(cfg) + 2 * norm + enc_mlp
        dec_per = 2 * _attn_params(cfg) + 3 * norm + enc_mlp
        total += (cfg.encoder_layers * enc_per + cfg.num_layers * dec_per
                  + norm + WHISPER_DEC_MAX_POS * D)
    return total
