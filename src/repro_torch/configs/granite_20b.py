"""Granite 20B code [arXiv:2405.04324]: llama-arch, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    rope_theta=10_000.0, attn_kind="full",
)
