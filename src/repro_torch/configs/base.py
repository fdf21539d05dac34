"""Config dataclasses (port of ``repro.configs.base``, copied as they are).

Every assigned architecture is expressed as a ``ModelConfig``; input shapes as
``ShapeConfig``. Configs are plain frozen dataclasses so they hash, print, and
serialize cleanly; nothing here imports torch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    # d_ff of each routed expert (shared experts use the same unless overridden)
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    router_jitter: float = 0.0
    # load-balancing aux loss weight
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    conv_width: int = 4
    expand: int = 1  # inner expansion for mamba blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention flavour: 'full' | 'swa' (sliding window) | 'none'
    attn_kind: str = "full"
    window: int = 2048  # for swa
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # modality frontend: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    n_patches: int = 256  # vision frontend: number of patch embeddings
    dtype: str = "bfloat16"
    # remat policy: 'none' | 'full' | 'dots'
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 64  # attention-free archs (rwkv heads)

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context (O(<seq^2) prefill, O(1)/O(w) cache)?"""
        return self.attn_kind in ("none", "swa") or self.family == "ssm"

    @property
    def n_params(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        per_layer = 0
        if self.attn_kind != "none" and self.n_heads:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.family in ("ssm",) or (self.ssm is not None and self.family == "hybrid"):
            # rwkv/mamba mixing params approx: 4 d^2-ish
            per_layer += 4 * d * d
        if self.moe is not None:
            e = self.moe
            per_layer += e.num_experts * 3 * d * e.expert_d_ff
            per_layer += e.num_shared * 3 * d * (e.shared_d_ff or e.expert_d_ff)
            per_layer += d * e.num_experts  # router
        else:
            per_layer += 3 * d * self.d_ff  # swiglu
        per_layer += 2 * d  # norms
        return emb + head + L * per_layer

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE uses top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params
        e = self.moe
        d, L = self.d_model, self.n_layers
        routed_all = e.num_experts * 3 * d * e.expert_d_ff
        routed_active = e.top_k * 3 * d * e.expert_d_ff
        return self.n_params - L * (routed_all - routed_active)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Shapes applicable to an arch. long_500k only for sub-quadratic archs
    (skip documented in DESIGN.md §Arch-applicability)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Train / runtime config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation
    grad_compression: str = "none"  # 'none' | 'bf16' | 'int8_ef'
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # single pod (data, model); multi-pod (pod, data, model)
    pod: int = 2
    data: int = 16
    model: int = 16

    @property
    def shape(self):
        return (self.pod, self.data, self.model) if self.multi_pod else (self.data, self.model)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=0,
        d_ff=128,
        vocab=512,
        head_dim=16 if cfg.n_heads else 16,
    )
    if cfg.n_heads:
        # preserve the GQA ratio shape (kv <= q heads)
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
        kw["n_kv_heads"] = max(1, kw["n_heads"] // min(ratio, kw["n_heads"]))
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            expert_d_ff=64,
            shared_d_ff=64,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_size=8)
    if cfg.frontend == "vision":
        kw["n_patches"] = 4
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
