"""PaliGemma 3B [arXiv:2407.07726]: SigLIP vision stub + gemma backbone (MQA).

The SigLIP tower is a stub: input_specs supplies 256 precomputed patch
embeddings which are prepended to the text embeddings; loss masks image slots.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    rope_theta=10_000.0, attn_kind="full", frontend="vision", n_patches=256,
)
