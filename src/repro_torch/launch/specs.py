"""Input stand-ins and sharding trees for the dry run.

Counterpart of ``repro/launch/specs.py``. ``input_specs(cfg, shape)``
gives the model inputs of an (arch x input-shape) pair as tensors on the
meta device: shapes and dtypes, no allocation. The modality stubs live
here: whisper gets (B, 1500, D) frame embeddings, paligemma (B, 256, D)
patch embeddings.

The sharding policy is the reference's (its DESIGN.md §4), each leaf's
split a tuple of one entry a dimension (``distributed.sharding``), with
its divisibility guards (a dim that does not divide its axis stays
whole):

  tokens (B, S)             -> (batch, seq)
  frames/patches (B, P, D)  -> (batch, seq?, None)
  kv cache (L, B, S, kv, h) -> (None, batch, seq, None, None)
  ssm state (L, B, H, P, N) -> (None, batch, tp?, None, None)
  conv state (L, B, K, C)   -> (None, batch, None, tp?)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.tokens import text_len
from repro_torch.distributed.sharding import (MeshRules, map_with_keys,
                                              params_sharding_tree)

META = torch.device("meta")


# --------------------------------------------------------------------------- #
# input stand-ins (meta tensors; no allocation)
# --------------------------------------------------------------------------- #

def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Model inputs for a train or prefill forward of (cfg, shape)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, text_len(cfg, S)), dtype=torch.int32,
                                   device=META)}
    if cfg.family == "encdec":
        specs["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                      device=META)
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((B, cfg.num_patch_tokens,
                                        cfg.d_model), device=META)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape,
                       dtype=torch.bfloat16) -> Tuple[Any, Any, Any]:
    """(token, cache, cache_pos) stand-ins for one ``decode_step``."""
    from repro_torch.models import factory
    B = shape.global_batch
    token = torch.empty((B, 1), dtype=torch.int32, device=META)
    cache = factory.init_cache(cfg, B, shape.seq_len, dtype=dtype,
                               device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return token, cache, pos


# --------------------------------------------------------------------------- #
# sharding trees
# --------------------------------------------------------------------------- #

def _div(n: int, axis_size: int) -> bool:
    return axis_size > 1 and n % axis_size == 0


def batch_shardings(specs: Dict[str, Any], rules: MeshRules):
    """tokens / frames / patches -> each one's split."""
    bsz = rules.axis_size(rules.batch)
    ssz = rules.axis_size(rules.seq)

    def one(leaf):
        dims = [None] * leaf.dim()
        if leaf.dim() >= 1 and _div(leaf.shape[0], bsz):
            dims[0] = rules.batch
        if leaf.dim() >= 2 and _div(leaf.shape[1], ssz):
            dims[1] = rules.seq
        return tuple(dims)

    return {k: one(v) for k, v in specs.items()}


def cache_shardings(cache, rules: MeshRules):
    """The KV-ring and SSM-state caches' splits by leaf name (see the
    module's docstring)."""
    bsz = rules.axis_size(rules.batch)
    ssz = rules.axis_size(rules.seq)
    tsz = rules.axis_size(rules.tp)

    def one(keys, leaf):
        name = str(keys[-1]) if keys else ""
        dims = [None] * leaf.dim()
        if name in ("k", "v", "xk", "xv"):
            # (L, B, S_ring, kv, hd) or (groups, B, S_ring, kv, hd)
            if _div(leaf.shape[1], bsz):
                dims[1] = rules.batch
            if _div(leaf.shape[2], ssz):
                dims[2] = rules.seq
        elif name == "ssm_state":
            # (L, B, H, P, N): the heads over tp when they divide
            if _div(leaf.shape[1], bsz):
                dims[1] = rules.batch
            if _div(leaf.shape[2], tsz):
                dims[2] = rules.tp
        elif name == "conv_state":
            # (L, B, K-1, C): the channels over tp
            if _div(leaf.shape[1], bsz):
                dims[1] = rules.batch
            if _div(leaf.shape[-1], tsz):
                dims[-1] = rules.tp
        elif leaf.dim() >= 2 and _div(leaf.shape[1], bsz):
            dims[1] = rules.batch
        return tuple(dims)

    return map_with_keys(one, cache)


def train_state_shardings(params, opt_state, rules: MeshRules):
    return (params_sharding_tree(params, rules),
            params_sharding_tree(opt_state, rules))


# --------------------------------------------------------------------------- #
# applicability (which decode shapes an arch runs)
# --------------------------------------------------------------------------- #

def shape_supported(cfg: ModelConfig, shape: InputShape
                    ) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic decode (the reference's DESIGN.md
    §3)."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False, ("enc-dec decoder is spec'd to 448 tokens; a "
                           "500k self-attn cache has no faithful meaning")
        if not cfg.sub_quadratic:
            return False, ("pure full-attention arch: 500k decode is "
                           "quadratic-cost; no SWA variant claimed by "
                           "the source")
    return True, ""
