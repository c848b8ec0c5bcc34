"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242] 38 core Mamba2 layers, d_model=2048, shared transformer
block (32 heads, kv=32, d_ff=8192) invoked every 6 core layers with shared
weights, ssm_state=64, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    rope_theta=10000.0,
    norm_eps=1e-5,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=256),
    hybrid_attn_every=6,
    # the shared attention block uses SWA for the long_500k decode shape
    sliding_window=4096,
    source="arXiv:2411.15242",
)
