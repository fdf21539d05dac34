"""Train and serve step builders (port of ``repro.train.train_step``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``:

* one forward and backward per microbatch over the batch's leading
  microbatch axis ((M, B/M, ...)), each microbatch's gradients summed in
  f32 and the sum divided by M, the loss likewise, as the reference's
  scan;
* optional gradient compression: ``"bf16"`` (a cast to bf16 and back) or
  ``"int8_ef"`` (per-tensor int8 with error feedback, the residual carried
  in ``state["ef"]``), where the reference applies it before its
  cross-replica reduce (one card has none);
* the AdamW update (``optim.adamw``).

The state is a dict: ``params`` (the trainable params tree), ``opt``
(``adamw.OptState`` of f32 moments by the parameters' names), ``step``
and, under int8_ef, ``ef`` (each parameter's f32 residual). A step
updates it in place, as ``decode_step`` updates its cache: parameters,
moments and residuals are written over, and the dict returned is the one
passed in.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.model import (decode_step, init_params, loss_fn,
                                      prefill)
from repro_torch.optim import adamw

TrainState = Dict[str, object]


def init_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
               device: DeviceLike = "cuda") -> TrainState:
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev, trainable=True)
    flat = dict(params.named_parameters())
    state: TrainState = {"params": params, "opt": adamw.init(flat),
                         "step": torch.zeros((), dtype=torch.int32,
                                             device=dev)}
    if tc.grad_compression == "int8_ef":
        state["ef"] = {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in flat.items()}
    return state


def _compress_bf16(g: Dict[str, torch.Tensor]) -> None:
    for k in g:
        g[k] = g[k].to(torch.bfloat16).float()


def _stacked(name: str) -> str:
    """The reference's leaf of a parameter: its layers are one tensor
    stacked on a leading axis (``layers.3.attn.wq`` -> ``layers.attn.wq``)."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" else name


def _compress_int8_ef(g: Dict[str, torch.Tensor],
                      ef: Dict[str, torch.Tensor]) -> None:
    """Error-feedback int8: ``x = g + ef`` quantised per tensor of the
    reference's tree (one scale ``max(|x|, 1e-12) / 127`` over a leaf's
    layers, as the reference's leaves stack them), rounded half to even as
    ``jnp.round``; the residual ``x - deq`` is written into ``ef``."""
    groups: Dict[str, list] = {}
    for k in g:
        groups.setdefault(_stacked(k), []).append(k)
    for names in groups.values():
        xs = {k: g[k].float() + ef[k] for k in names}
        top = torch.stack([x.abs().amax() for x in xs.values()]).amax()
        scale = torch.clamp(top, min=1e-12) / 127.0
        for k, x in xs.items():
            deq = torch.round(x / scale).to(torch.int8).float() * scale
            ef[k].copy_(x - deq)
            g[k] = deq


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Metrics: ``loss``, ``aux`` (the MoE aux loss, 0 for the other
        families; both means over microbatches), ``grad_norm``, ``lr``."""
        named = list(state["params"].named_parameters())
        leaves = [p for _, p in named]
        dev = leaves[0].device
        gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in named}
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        asum = torch.zeros((), dtype=torch.float32, device=dev)
        n_mb = batch["tokens"].shape[0]
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items()}
            loss, parts = loss_fn(state["params"], cfg, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            for (k, _), g in zip(named, grads):
                gsum[k].add_(g)
            del grads
            lsum = lsum + loss.detach()
            asum = asum + parts["aux"].detach()
        for g in gsum.values():
            g.div_(n_mb)
        with torch.no_grad():
            if tc.grad_compression == "bf16":
                _compress_bf16(gsum)
            elif tc.grad_compression == "int8_ef":
                _compress_int8_ef(gsum, state["ef"])
            new, opt, om = adamw.update(gsum, state["opt"], dict(named), tc)
            del gsum
            for k, p in named:
                p.copy_(new.pop(k))
        state["opt"] = opt
        state["step"] = state["step"] + 1
        return state, {"loss": lsum / n_mb, "aux": asum / n_mb, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)
    return serve_step
