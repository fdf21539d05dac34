"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32 experts top-8, expert d_ff=512."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    rope_theta=10_000.0, attn_kind="full",
    moe=MoEConfig(num_experts=32, top_k=8, num_shared=0,
                  expert_d_ff=512, shared_d_ff=512),
)
