"""Granite 4.0-H Micro (3B) — interleaved Mamba-2 / NoPE GQA hybrid.

[hf:ibm-granite/granite-4.0-h-micro, config.json:
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json]
model_type granitemoehybrid with no experts: 40 layers of d_model 2048,
``layer_types`` a 10-layer period (Mamba-2 at 0-4 and 6-9, attention at
5); Mamba-2 mixers of 64 heads of 64, d_state 128, one group, d_conv 4
with a bias, chunk 256, expand 2; GQA 32 / 8 heads of 64 with no position
embedding; a SwiGLU MLP of 8192 after every mixer; embedding x 12,
softmax scale 0.015625, residual branches x 0.22, logits / 8; RMSNorm eps
1e-5, vocabulary 100,352, tied embeddings. 3,191,396,096 parameters.
"""
from repro_torch.configs.base import InterleavedConfig, SSMConfig

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = InterleavedConfig(
    name="granite-4.0-h-micro",
    family="interleaved",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=100352,
    rope_theta=10000.0,
    use_rope=False,
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=256, ngroups=1),
    layer_types=PERIOD * 4,
    embedding_multiplier=12.0,
    attention_multiplier=0.015625,
    residual_multiplier=0.22,
    logits_scaling=8.0,
    source="hf:ibm-granite/granite-4.0-h-micro",
)
