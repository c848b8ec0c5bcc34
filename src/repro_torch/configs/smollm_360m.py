"""SmolLM-360M — llama-arch small dense model.

[hf:HuggingFaceTB/SmolLM-135M family; 360M variant numbers per assignment]
32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
