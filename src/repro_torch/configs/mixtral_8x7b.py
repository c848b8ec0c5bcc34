"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] 32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=14336,
vocab=32000, SWA window 4096.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=14336),
    source="arXiv:2401.04088",
)
