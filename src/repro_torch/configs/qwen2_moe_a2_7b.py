"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 60 routed experts top-4 +
4 shared experts, expert d_ff=1408."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    rope_theta=1_000_000.0, attn_kind="full",
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4,
                  expert_d_ff=1408, shared_d_ff=1408),
)
