"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch
(port of ``repro.models.moe``).

The reference's plan, row by row: the router's softmax in f32, top-k
experts per token with their weights renormalised, the (token, expert)
pairs sorted stably by expert, each pair's position within its expert,
and a pair kept while its position is below the capacity C. Its dispatch
writes every pair into an (E*C, D) buffer at ``slot = e*C + min(pos,
C-1)``, the dropped pairs as zeros, and XLA applies those duplicate
writes in order: where an expert takes more than C pairs, the zeros of
its dropped pairs overwrite the kept pair at position C-1, which then
gets nothing from that expert. The port computes the same thing on
purpose and never by the order of duplicate writes (PyTorch leaves that
order undefined on CUDA): a pair is *live* iff its position is below
C-1, or it is C-1 and the expert took no more than C pairs. Only live
pairs reach a buffer, and each buffer slot has at most one, so the
dispatch is a gather by a slot-to-token map written at distinct indices.

Every step is deterministic on the card: no float atomics (the counts of
the GShard aux loss come from the sorted experts), the combine gathers
each token's k slots and sums them in a fixed order. The combine sums
the k weighted terms in f32 and rounds once to the activation dtype,
where the reference adds them in that dtype (the same in f32; in bf16
within the bf16 bounds of the tests).

The layer's sequence chunks and batch rows are independent: they are
stacked as rows of one dispatch (R = B * chunks) instead of the
reference's scan over chunks and vmap over rows. The experts' SwiGLU runs
as batched matrix products over experts on (E, R*C, D) buffers; the MoE
layer has no Pallas kernel in the reference (its products are einsums
and its dispatch is sort, gather and scatter in XLA).

``moe_layer.dropped`` accumulates, on the device and without a host
sync, the pairs that got nothing from their expert (the pairs past C and
the overwritten pair at C-1); set it to 0 to reset it. The profiler
ranges ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` name the
layer's parts for a device-time split.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x (..., T, D), w_router (D, E) -> softmax probs (..., T, E) in f32."""
    return torch.softmax(x.float() @ w_router.float(), dim=-1)


class Plan(NamedTuple):
    """A dispatch plan over rows of T tokens, the pairs in expert order:
    the reference's ``(slot, weight, src_token, aux)`` and the positions
    within each expert with the live mask."""
    slot: torch.Tensor       # (..., T*k) e*C + min(pos, C-1)
    weight: torch.Tensor     # (..., T*k) f32, 0 where pos >= C
    src_token: torch.Tensor  # (..., T*k) the pair's token
    aux: torch.Tensor        # (...,) GShard load-balance loss
    pos: torch.Tensor        # (..., T*k) position within its expert
    live: torch.Tensor       # (..., T*k) the pair gets its expert's output
    order: torch.Tensor      # (..., T*k) the pair's flat (token, j) index


def dispatch_plan(probs: torch.Tensor, top_k: int, capacity: int) -> Plan:
    """The sort-based plan of ``probs`` (..., T, E), each leading index a
    row of its own."""
    *lead, T, E = probs.shape
    vals, ids = torch.topk(probs, top_k, dim=-1)          # sorted, descending
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = ids.reshape(*lead, T * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(T * top_k, device=probs.device) - first
    experts = torch.arange(E, device=probs.device).expand(
        *lead, E).contiguous()
    count = torch.searchsorted(sorted_e, experts, side="right") \
        - torch.searchsorted(sorted_e, experts, side="left")
    keep = pos < capacity
    slot = sorted_e * capacity + torch.clamp(pos, max=capacity - 1)
    weight = torch.where(keep, torch.gather(vals.reshape(*lead, T * top_k),
                                            -1, order), 0.0)
    aux = E * (probs.mean(-2) * (count.float() / (T * top_k))).sum(-1)
    live = (pos < capacity - 1) | ((pos == capacity - 1)
                                   & (torch.gather(count, -1, sorted_e)
                                      <= capacity))
    return Plan(slot, weight, order // top_k, aux, pos, live, order)


def topk_dispatch(probs: torch.Tensor, top_k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The reference's plan for T tokens, probs (T, E): (slot, weight,
    src_token, aux), each (T*k,) in expert order, aux a scalar."""
    return dispatch_plan(probs, top_k, capacity)[:4]


def expert_capacity(chunk: int, cfg: MoEConfig,
                    capacity_factor: float = 1.25) -> int:
    """The slots of each expert in a chunk of ``chunk`` tokens."""
    return max(int(chunk * cfg.top_k * capacity_factor / cfg.num_experts),
               4)


def moe_layer(x: torch.Tensor, params, cfg: MoEConfig,
              capacity_factor: float = 1.25, seq_chunk: int = 4096
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D). Returns (y (B,S,D) in x's dtype, aux f32), the
    reference's chunks along the sequence (``min(seq_chunk, S)``, S when
    that does not divide it) each dispatched on its own."""
    B, S, D = x.shape
    chunk = min(seq_chunk, S)
    if S % chunk:
        chunk = S
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(chunk, cfg, capacity_factor)
    R = B * (S // chunk)
    xr = x.reshape(R, chunk, D)
    dev = x.device

    with record_function("moe.dispatch"):
        plan = dispatch_plan(router_probs(xr, params["router"]), k, C)
        rows = torch.arange(R, device=dev)[:, None]
        e_of = torch.div(plan.slot, C, rounding_mode="floor")
        # buffers laid out (E, R, C): a live pair's slot and its token
        flat = e_of * (R * C) + rows * C + torch.clamp(plan.pos, max=C - 1)
        write = plan.live & (plan.weight > 0)
        tok = torch.full((E * R * C + 1,), R * chunk, dtype=torch.long,
                         device=dev)
        tok.scatter_(0, torch.where(write, flat, E * R * C).reshape(-1),
                     (rows * chunk + plan.src_token).reshape(-1))
        x_pad = torch.cat([xr.reshape(R * chunk, D),
                           x.new_zeros((1, D))])
        buf = x_pad[tok[:-1]].reshape(E, R * C, D)
        moe_layer.dropped = moe_layer.dropped + (~plan.live).sum()

    with record_function("moe.experts"):
        h = F.silu(torch.bmm(buf, params["w1"])) \
            * torch.bmm(buf, params["w3"])
        ye = torch.bmm(h, params["w2"]).reshape(E * R * C, D)
        shared = L.swiglu(x, params["sw1"], params["sw3"], params["sw2"]) \
            if cfg.num_shared else None

    with record_function("moe.combine"):
        # back to (token, j) order: each token's k slots and weights
        w_live = torch.where(write, plan.weight, 0.0)
        by_pair = torch.empty_like(flat).scatter_(-1, plan.order, flat)
        w_pair = torch.empty_like(w_live).scatter_(-1, plan.order, w_live)
        y = (ye[by_pair.reshape(R, chunk, k)].float()
             * w_pair.reshape(R, chunk, k, 1)).sum(-2)
        y = y.to(x.dtype).reshape(B, S, D)
        if shared is not None:      # added after the routed sum
            y = y + shared
    return y, plan.aux.mean()


moe_layer.dropped = 0
