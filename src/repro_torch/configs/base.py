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
from typing import Optional, Tuple


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
                                  # | interleaved (InterleavedConfig)
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

    # ---- derived quantities -------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def sub_quadratic(self) -> bool:
        """True if decode over very long context is O(1)/O(window) per token."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), matches init_params."""
        from repro_torch.models.factory import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.factory import count_params_analytic
        return count_params_analytic(self, active_only=True)

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
class InterleavedConfig(ModelConfig):
    """A backbone whose layers follow ``layer_types``, each ``"mamba"``
    (a Mamba-2 mixer) or ``"attention"`` (GQA), every mixer followed by
    its own SwiGLU MLP (the ``interleaved`` family: granitemoehybrid with
    no experts). The four scalars are granite's: the embedding times
    ``embedding_multiplier``, ``attention_multiplier`` the softmax scale
    in place of 1/sqrt(head_dim), both residual branches of a layer times
    ``residual_multiplier``, the logits over ``logits_scaling``. A port
    config of its own, so the reference's configs keep their fields."""
    layer_types: Tuple[str, ...] = ()
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_types) != self.num_layers or not set(
                self.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"{self.name}: layer_types must give "
                             f"num_layers = {self.num_layers} kinds, each "
                             f"'mamba' or 'attention'")

    def period(self) -> int:
        """The length of the shortest prefix of ``layer_types`` that,
        repeated, gives all of it."""
        types, n = self.layer_types, self.num_layers
        return next(p for p in range(1, n + 1) if n % p == 0
                    and types == types[:p] * (n // p))

    def reduced(self, num_layers: Optional[int] = None,
                **kw) -> "InterleavedConfig":
        """``ModelConfig.reduced`` over the first ``num_layers`` of
        ``layer_types`` (by default one whole period, ``period()``), the
        multipliers kept."""
        n = self.period() if num_layers is None else num_layers
        cut = dataclasses.replace(self, num_layers=n,
                                  layer_types=self.layer_types[:n])
        return ModelConfig.reduced(cut, num_layers=n, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class RunConfig:
    """What the trainer and the server need besides the model itself,
    with the reference's defaults: the forward runs in ``compute_dtype``
    over ``param_dtype`` parameters (norms, softmax and RoPE in float32);
    training takes ``optimizer`` (adamw, adam or sgd) at
    ``learning_rate`` with ``weight_decay``, clips the gradients' global
    norm at ``grad_clip`` (0: no clipping) and under ``remat``
    checkpoints each layer. The reference's distribution fields (fsdp,
    tensor and sequence parallelism) and ``use_pallas`` have no
    counterpart: the port runs on one card and always calls its
    kernels."""
    model: ModelConfig
    shape: InputShape
    # optimization
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    optimizer: str = "adamw"
    grad_clip: float = 1.0
    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True            # activation checkpointing over the layers
