"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Backbone only; the EnCodec frontend is a stub (input_specs supplies token ids
over the 2048-entry codebook directly).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, head_dim=64,
    rope_theta=10_000.0, attn_kind="full", frontend="audio",
)
