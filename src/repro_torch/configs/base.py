"""Config system: model configs, input shapes, run configs.

A copy of ``repro/configs/base.py`` (pure data; the port imports nothing
of the JAX package). Every ported architecture gets one file in this
package defining a ``ModelConfig`` with the exact public numbers (cited
in the file header). ``RunConfig`` keeps the fields the serving path
reads; the reference's optimisation and distribution fields come with
the training and multi-GPU slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    expert_d_ff: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block config."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    conv_dim: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window, None = full attention
    rope_theta: float = 10000.0
    use_rope: bool = True
    # norm / activation
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE / SSM
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): shared attention block every k core layers
    hybrid_attn_every: int = 0
    # enc-dec (whisper-style)
    encoder_layers: int = 0
    encoder_seq: int = 0          # fixed encoder memory length (1500 whisper)
    # vlm (paligemma-style)
    num_patch_tokens: int = 0     # prepended patch embeddings
    # citation for the numbers above
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), matches init_params."""
        from repro_torch.models.factory import count_params_analytic
        return count_params_analytic(self)

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads if heads else 0,
            d_ff=d_model * 2,
            vocab_size=vocab,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                experts_per_token=min(self.moe.experts_per_token, 2),
                expert_d_ff=d_model * 2,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 32), chunk_size=32)
        if self.encoder_layers:
            changes["encoder_layers"] = num_layers
            changes["encoder_seq"] = min(self.encoder_seq, 32)
        if self.num_patch_tokens:
            changes["num_patch_tokens"] = min(self.num_patch_tokens, 16)
        if self.sliding_window is not None:
            changes["sliding_window"] = min(self.sliding_window, 64)
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


@dataclass(frozen=True)
class RunConfig:
    """What the server needs besides the model itself: the forward runs
    in ``compute_dtype`` over float32 parameters (norms, softmax and RoPE
    in float32)."""
    model: ModelConfig
    shape: InputShape
    compute_dtype: str = "bfloat16"
