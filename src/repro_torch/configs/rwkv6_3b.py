"""RWKV-6 (Finch) 3B [arXiv:2404.05892]: attention-free, data-dependent decay
linear attention; 40 heads of 64 channels."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536, head_dim=64,
    attn_kind="none", ssm=SSMConfig(state_size=64),
)
