"""Stand-ins for every (arch x shape) cell as tensors on the ``meta``
device (port of ``repro.launch.input_specs``, whose ``ShapeDtypeStruct``
stand-ins feed ``jit(...).lower()``).

No memory is allocated and nothing is drawn: each leaf has its shape and
dtype only. ``roofline.analysis.analyze`` runs a step on them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.model import init_cache, init_params
from repro_torch.train.train_step import init_state

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _text_len(cfg: ModelConfig, S: int) -> int:
    """Tokens of a sequence of S positions: the vision frontend's
    ``n_patches`` patch embeddings come first."""
    return S - cfg.n_patches if cfg.frontend == "vision" else S


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      microbatches: int = 1) -> Dict[str, Any]:
    """Train batch, with leading microbatch axis (M, B/M, ...)."""
    B, S = shape.global_batch, shape.seq_len
    assert B % microbatches == 0
    mb = B // microbatches
    batch = {
        "tokens": _sds((microbatches, mb, _text_len(cfg, S)), torch.int32),
        "labels": _sds((microbatches, mb, S), torch.int32),
        "mask": _sds((microbatches, mb, S), torch.int32),
    }
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _sds(
            (microbatches, mb, cfg.n_patches, cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, _text_len(cfg, S)), torch.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _sds((B, cfg.n_patches, cfg.d_model),
                                     torch.bfloat16)
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, Any]:
    """(cache, tokens) for one decode step with a cache of ``seq_len``
    tokens already resident."""
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, fill=S - 1, device=META)
    return cache, _sds((B,), torch.int32)


def abstract_state(cfg: ModelConfig, tc: TrainConfig):
    return init_state(cfg, tc, device=META)


def abstract_params(cfg: ModelConfig):
    return init_params(cfg, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig = None,
                microbatches: int = 1):
    """The full input tuple of the cell's step function
    (``train.train_step``'s ``make_*_step``)."""
    tc = tc or TrainConfig(microbatches=microbatches)
    if shape.kind == "train":
        return (abstract_state(cfg, tc),
                train_batch_specs(cfg, shape, tc.microbatches))
    if shape.kind == "prefill":
        return (abstract_params(cfg), prefill_batch_specs(cfg, shape))
    if shape.kind == "decode":
        cache, tokens = decode_inputs(cfg, shape)
        return (abstract_params(cfg), cache, tokens)
    raise ValueError(shape.kind)
