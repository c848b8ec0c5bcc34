"""Kimi-K2 — trillion-parameter MoE, 32B active (paper-table entry).

[arXiv:2501.kimi2 per assignment] 61L, d_model=7168, 64 heads (GQA kv=8),
expert d_ff=2048, vocab=163840, MoE 384 experts top-8 + 1 shared expert
(DeepSeek-V3-style fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=384, experts_per_token=8, expert_d_ff=2048,
                  num_shared_experts=1),
    source="arXiv:2501.kimi2",
)
