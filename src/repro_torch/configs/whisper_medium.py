"""Whisper-medium — encoder-decoder audio model (conv frontend STUBBED).

[arXiv:2212.04356] 24 enc + 24 dec layers, d_model=1024, 16 heads, d_ff=4096,
vocab=51865, encoder memory = 1500 frames. Learned positions (no RoPE).
input_specs() provides precomputed (B, 1500, d_model) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    use_rope=False,
    norm_eps=1e-5,
    encoder_layers=24,
    encoder_seq=1500,
    source="arXiv:2212.04356",
)
