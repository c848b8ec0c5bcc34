"""Mamba2-130M — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060] 24L, d_model=768, d_inner=1536 (expand=2), state N=128,
head dim P=64, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    use_rope=False,
    tie_embeddings=True,
    norm_eps=1e-5,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=256),
    source="arXiv:2405.21060",
)
