"""PaliGemma-3B — VLM: SigLIP vision encoder (STUBBED) + Gemma-2B decoder.

[arXiv:2407.07726] 18L, d_model=2048, 8 heads (GQA kv=1, head_dim=256),
d_ff=16384, vocab=257216, 256 patch tokens prepended.
input_specs() provides precomputed (B, 256, d_model) patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10000.0,
    tie_embeddings=True,
    num_patch_tokens=256,
    source="arXiv:2407.07726",
)
