"""AdamW + cosine schedule + global-norm clipping on flat parameter dicts
(port of ``repro.optim.adamw``, with its arithmetic in the same order).

Parameters, gradients and moments are ``{name: tensor}`` dicts; leaves are
visited in sorted-key order, as the reference's pytrees flatten, and
``update`` walks them one at a time with the moments updated in place.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor    # () int32


def init(params: Tree) -> OptState:
    def zeros(p):
        return torch.zeros_like(torch.as_tensor(p), dtype=torch.float32)
    keys = sorted(params)
    dev = torch.as_tensor(params[keys[0]]).device if keys else None
    return OptState(m={k: zeros(params[k]) for k in keys},
                    v={k: zeros(params[k]) for k in keys},
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_lr(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    return tc.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def update(grads: Tree, opt: OptState, params: Tree, tc: TrainConfig
           ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).

    The global norm is taken over every gradient first; then the leaves
    are walked one at a time, so only one leaf's f32 temporaries (the
    clipped gradient, the bias-corrected moments, the step) are alive at
    once, as a full-width model on one card needs. The moments are
    updated in place: ``opt.m`` and ``opt.v`` are the returned state's.
    The arithmetic is the reference's, op for op and in its order."""
    keys = sorted(params)
    gnorm = global_norm(grads)
    scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = opt.count + 1
    lr = cosine_lr(tc, count)
    b1, b2 = tc.beta1, tc.beta2
    new = {}
    for k in keys:
        g = grads[k].float() * scale
        m = opt.m[k].mul_(b1).add_((1 - b1) * g)
        v = opt.v[k].mul_(b2).add_((1 - b2) * g * g)
        del g
        mh = m / (1 - b1 ** count)
        vh = v / (1 - b2 ** count)
        p = params[k]
        step = lr * (mh / (torch.sqrt(vh) + 1e-8)
                     + tc.weight_decay * p.float())
        new[k] = (p.float() - step).to(p.dtype)
    return new, OptState(opt.m, opt.v, count), {"grad_norm": gnorm,
                                                "lr": lr}
