"""Qwen2.5-32B — dense, GQA, QKV bias.

[hf:Qwen/Qwen2.5-0.5B card family; 32B numbers per assignment]
64L, d_model=5120, 40 heads (GQA kv=8), d_ff=27648, vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)
