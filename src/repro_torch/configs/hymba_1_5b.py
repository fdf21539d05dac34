"""Hymba 1.5B [arXiv:2411.13676]: hybrid — parallel attention + mamba heads,
sliding-window attention (global attention only on a few layers; we model SWA
throughout which is what makes long_500k feasible), ssm_state=16."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    rope_theta=10_000.0, attn_kind="swa", window=1024,
    ssm=SSMConfig(state_size=16),
)
