"""Model zoo: init, prefill, decode and the training loss (port of
``repro.models.model``),
families ``dense`` (decoder transformer: GQA, RoPE, SwiGLU), ``audio``
(the same decoder over EnCodec token ids: the reference's frontend is a
stub and its audio family takes the dense path), ``moe`` (dense attention
and a mixture-of-experts FFN, ``models.moe``), ``hybrid`` (hymba: each
block runs sliding-window attention and a mamba head, ``models.ssm``, side
by side on the same input), ``vlm`` (paligemma: the dense decoder behind
the vision frontend, whose ``n_patches`` patch embeddings come before the
text and are seen by every position, prefix-LM attention through K6; the
SigLIP tower is a stub, as in the reference) and ``ssm`` (RWKV6
time-mix / channel-mix).

Parameters are an ``nn.Module`` tree whose names follow the reference's
params tree: ``embed``, ``layers.<i>.attn.wq``, ``layers.<i>.tm.mu_r``,
``final_norm``, ``lm_head``; each node is indexed like the reference's dict
(``lp["attn"]["wq"]``). The parameters are frozen (``requires_grad``
False) unless ``init_params(..., trainable=True)`` or
``params.requires_grad_(True)`` asks for gradients. The reference stacks
the layers on a leading axis and scans them under remat; here they are an
``nn.ModuleList`` walked by a Python loop, each layer under
``torch.utils.checkpoint`` by ``cfg.remat`` when grad is enabled (the
prefill runs without grad and without remat). The reference's
``act_sharding.shard_*`` constraints are no-ops outside a mesh and are
dropped (one card).

:func:`loss_fn` is the reference's: chunked cross-entropy plus the MoE
aux loss, for every family. Its kernels are autograd Functions: K6
(``FlashAttention``), K7 (``RwkvChunk``, the ssm family's chunked WKV)
and K8 (``SsmScan``, the hybrid family's mamba heads).

The decode cache is a dict of tensors as the reference's, updated in
place by :func:`decode_step` (the reference returns a new one). Prefill
writes nothing into it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the families the port serves (every family of the model zoo)
SERVED_FAMILIES = ("dense", "audio", "moe", "hybrid", "vlm", "ssm")
# the families loss_fn differentiates: every served family
TRAINED_FAMILIES = SERVED_FAMILIES


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in SERVED_FAMILIES or \
            cfg.frontend not in ("none", "audio", "vision"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r})"
            f" is no family of the model zoo: the port serves "
            f"{SERVED_FAMILIES} with frontends none, audio and vision; "
            "another would be a new ROADMAP queue-A item")


class Tree(nn.Module):
    """A node of the params tree: sub-trees and parameters (frozen until
    ``requires_grad_(True)``) by the reference's keys, read with
    ``node["key"]``."""

    def __init__(self, leaves: Dict[str, object]):
        super().__init__()
        for key, val in leaves.items():
            if isinstance(val, nn.Module):
                self.add_module(key, val)
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class _Init:
    """The reference's initialisers from one explicit generator."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def normal(self, shape, dtype, scale=0.02) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device) * scale
        return x.to(dtype)

    def full(self, shape, value) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


def _init_layer(init: _Init, cfg: ModelConfig) -> Tree:
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    norms = {"norm1": init.full((d,), 0.0), "norm2": init.full((d,), 0.0)}
    if cfg.family == "ssm":
        lora = 64
        tm = {f"mu_{c}": init.full((d,), 0.5) for c in "rkvwg"}
        tm.update({
            "wr": init.normal((d, d), dt), "wk": init.normal((d, d), dt),
            "wv": init.normal((d, d), dt), "wg": init.normal((d, d), dt),
            "wo": init.normal((d, d), dt, out_scale),
            "w0": init.full((d,), -1.0),
            "wa": init.normal((d, lora), torch.float32),
            "wb": init.normal((lora, d), torch.float32),
            "u": init.full((d,), 0.0), "ln_w": init.full((d,), 1.0),
            "ln_b": init.full((d,), 0.0)})
        cm = {"mu_ck": init.full((d,), 0.5), "mu_cr": init.full((d,), 0.5),
              "ck": init.normal((d, cfg.d_ff), dt),
              "cv": init.normal((cfg.d_ff, d), dt, out_scale),
              "cr": init.normal((d, d), dt)}
        return Tree({"tm": Tree(tm), "cm": Tree(cm), **norms})
    attn = {"wq": init.normal((d, cfg.n_heads, hd), dt),
            "wk": init.normal((d, cfg.n_kv_heads, hd), dt),
            "wv": init.normal((d, cfg.n_kv_heads, hd), dt),
            "wo": init.normal((cfg.n_heads, hd, d), dt, out_scale)}
    if cfg.moe is not None:
        return Tree({**norms, "attn": Tree(attn),
                     "moe": Tree(_init_moe(init, cfg, dt, out_scale))})
    mlp = {"w1": init.normal((d, cfg.d_ff), dt),
           "w3": init.normal((d, cfg.d_ff), dt),
           "w2": init.normal((cfg.d_ff, d), dt, out_scale)}
    if cfg.family == "hybrid":
        return Tree({**norms, "attn": Tree(attn),
                     "mamba": Tree(_init_mamba(init, cfg, dt, out_scale)),
                     "norm_a": init.full((d,), 0.0),
                     "norm_s": init.full((d,), 0.0), "mlp": Tree(mlp)})
    return Tree({**norms, "attn": Tree(attn), "mlp": Tree(mlp)})


def _init_mamba(init: _Init, cfg: ModelConfig, dt, out_scale) -> dict:
    """The reference's ``_init_mamba``: ``w_dt``, ``dt_bias`` (-2),
    ``a_log`` (0) and ``d_skip`` (1) in f32, the conv kernel at scale 0.5,
    inner width ``d_model * expand``."""
    d = cfg.d_model
    di = d * cfg.ssm.expand
    H = di // cfg.resolved_head_dim
    n = cfg.ssm.state_size
    return {"w_in": init.normal((d, 2 * di), dt),
            "conv_k": init.normal((cfg.ssm.conv_width, di), dt, 0.5),
            "w_dt": init.normal((di, H), torch.float32),
            "dt_bias": init.full((H,), -2.0),
            "w_b": init.normal((di, n), dt), "w_c": init.normal((di, n), dt),
            "a_log": init.full((H,), 0.0), "d_skip": init.full((H,), 1.0),
            "w_out": init.normal((di, d), dt, out_scale)}


def _init_moe(init: _Init, cfg: ModelConfig, dt, out_scale) -> dict:
    """The reference's ``_init_moe``: an f32 router, the routed experts'
    (E, d, f) / (E, f, d) SwiGLU and the shared experts' at
    ``num_shared * (shared_d_ff or expert_d_ff)``."""
    e, d = cfg.moe, cfg.d_model
    E, f = e.num_experts, e.expert_d_ff
    p = {"router": init.normal((d, E), torch.float32),
         "w1": init.normal((E, d, f), dt), "w3": init.normal((E, d, f), dt),
         "w2": init.normal((E, f, d), dt, out_scale)}
    if e.num_shared:
        fs = e.num_shared * (e.shared_d_ff or e.expert_d_ff)
        p.update(sw1=init.normal((d, fs), dt), sw3=init.normal((d, fs), dt),
                 sw2=init.normal((fs, d), dt, out_scale))
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda", trainable: bool = False) -> Tree:
    """Random weights from ``seed`` with the reference's distributions and
    constants (normal x 0.02; output projections x 1/sqrt(2L); mu 0.5,
    w0 -1, u 0, norms 0), frozen unless ``trainable``. The bits differ
    from the reference's ``jax.random``; ``interop.params_from_numpy``
    carries its weights."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = _Init(gen, dev)
    p = {"embed": init.normal((cfg.vocab, cfg.d_model), _dtype(cfg))}
    p["layers"] = nn.ModuleList(_init_layer(init, cfg)
                                for _ in range(cfg.n_layers))
    p["final_norm"] = init.full((cfg.d_model,), 0.0)
    if not cfg.tie_embeddings:
        p["lm_head"] = init.normal((cfg.vocab, cfg.d_model), _dtype(cfg))
    return Tree(p).requires_grad_(trainable)


def _emb_out(params: Tree) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"]


# ---------------------------------------------------------------------------
# Forward (prefill and training)
# ---------------------------------------------------------------------------


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk')."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


def _attn_block(x, p, cfg: ModelConfig, positions, prefix_len=0):
    q = L.apply_rope(_proj_heads(x, p["wq"]), positions, cfg.rope_theta)
    k = L.apply_rope(_proj_heads(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_heads(x, p["wv"])
    window = cfg.window if cfg.attn_kind == "swa" else 0
    o = L.attention(q, k, v.contiguous(), causal=True, window=window,
                    prefix_len=prefix_len)
    return _proj_out(o, p["wo"])


def _ffn(h, lp, cfg: ModelConfig):
    """The block's FFN: (y, aux), the MoE layer with its load-balance aux
    loss or the dense SwiGLU with aux 0."""
    if cfg.moe is not None:
        return MOE.moe_layer(h, lp["moe"], cfg.moe)
    mlp = lp["mlp"]
    return L.swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"]), 0.0


def _layer_fwd(x, lp, cfg: ModelConfig, positions, prefix_len=0):
    """One block: (x, aux)."""
    if cfg.family == "ssm":
        B, d = x.shape[0], cfg.d_model
        hd = cfg.resolved_head_dim
        zeros = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        y, _, _ = RWKV.time_mix_chunked(h, zeros, None, lp["tm"], d // hd,
                                        hd, return_state=False)
        x = x + y
        h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        y, _ = RWKV.channel_mix(h, zeros, lp["cm"])
        return x + y, 0.0
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    a = _attn_block(h, lp["attn"], cfg, positions, prefix_len)
    if cfg.family == "hybrid":
        hd, ssm = cfg.resolved_head_dim, cfg.ssm
        st = SSM.init_mamba_state(x.shape[0], cfg.d_model * ssm.expand, hd,
                                  ssm.state_size, ssm.conv_width, x.dtype,
                                  x.device)
        s, _ = SSM.mamba_head(h, lp["mamba"], st, hd, ssm.state_size)
        a = _mix_heads(a, s, lp, cfg)
    x = x + a
    y, aux = _ffn(L.rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg)
    return x + y, aux


def _mix_heads(a, s, lp, cfg: ModelConfig):
    """The hybrid block's attention and mamba outputs, each normed, then
    averaged."""
    return 0.5 * (L.rms_norm(a, lp["norm_a"], cfg.norm_eps)
                  + L.rms_norm(s, lp["norm_s"], cfg.norm_eps))


def embed_inputs(params: Tree, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Returns (x (B,S,D), prefix_len). The vision frontend puts
    ``batch["patch_embeds"]`` (B, n_patches, D), cast to the embeddings'
    dtype, in front of the text's and returns ``prefix_len = n_patches``;
    the audio family's EnCodec ids are tokens (its frontend is a stub, as
    in the reference)."""
    _check_family(cfg)
    tok = params["embed"][batch["tokens"]]
    if cfg.frontend == "vision":
        pe = batch["patch_embeds"].to(tok.dtype)
        return torch.cat([pe, tok], dim=1), cfg.n_patches
    return tok, 0


def _dots_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy: keep the matrix products' outputs,
    recompute the rest (the reference's
    ``dots_with_no_batch_dims_saveable``; here batched products too)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(layer_fn, cfg: ModelConfig):
    """``layer_fn`` under the reference's remat policy ``cfg.remat``:
    ``"full"`` saves each layer's inputs and recomputes the layer in the
    backward, ``"dots"`` also keeps its matrix products, ``"none"`` saves
    everything. Applied only when grad is enabled."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer_fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, layer_fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, layer_fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_saveable))
    raise ValueError(f"remat {cfg.remat!r} is not 'none', 'full' or 'dots'")


def backbone(params: Tree, cfg: ModelConfig, x: torch.Tensor,
             prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer; returns (the final-normed hidden (B,S,D), the MoE
    aux loss summed over layers, f32). The first ``prefix_len`` positions
    are seen by every position (prefix-LM)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layer = _remat(_layer_fwd, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, a = layer(x, lp, cfg, positions, prefix_len)
        aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux"}): the masked chunked cross-entropy of
    ``batch["labels"]`` under ``batch["mask"]`` (zeros over the vision
    frontend's patches), plus ``aux_loss_weight * aux / n_layers`` for the
    moe family, as the reference's, for every family of the model zoo."""
    x, prefix_len = embed_inputs(params, cfg, batch)
    h, aux = backbone(params, cfg, x, prefix_len)
    ce = L.chunked_ce_loss(h, _emb_out(params), batch["labels"],
                           batch["mask"].float())
    moe_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    loss = ce + moe_w * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(params: Tree, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Serve prefill: the last position's logits (B,V) in f32."""
    x, prefix_len = embed_inputs(params, cfg, batch)
    h = backbone(params, cfg, x, prefix_len)[0]
    return h[:, -1].float() @ _emb_out(params).float().T


# ---------------------------------------------------------------------------
# Decode (single token, stateful cache)
# ---------------------------------------------------------------------------


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    if cfg.attn_kind == "swa":
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, fill: int = 0,
               device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A zero cache with ``pos = fill`` (the number of tokens counted as
    already in it)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    Lr, hd = cfg.n_layers, cfg.resolved_head_dim
    c = {"pos": torch.full((), fill, dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        d = cfg.d_model
        c["S"] = torch.zeros((Lr, batch, d // hd, hd, hd),
                             dtype=torch.float32, device=dev)
        c["x_tm"] = torch.zeros((Lr, batch, 1, d), dtype=dt, device=dev)
        c["x_cm"] = torch.zeros((Lr, batch, 1, d), dtype=dt, device=dev)
        return c
    W = cache_capacity(cfg, max_len)
    c["k"] = torch.zeros((Lr, batch, W, cfg.n_kv_heads, hd), dtype=dt,
                         device=dev)
    c["v"] = torch.zeros_like(c["k"])
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        di = cfg.d_model * ssm.expand
        c["ssm_h"] = torch.zeros((Lr, batch, di // hd, hd, ssm.state_size),
                                 dtype=torch.float32, device=dev)
        c["conv"] = torch.zeros((Lr, batch, ssm.conv_width - 1, di),
                                dtype=dt, device=dev)
    return c


def _decode_attn(x, p, cfg: ModelConfig, kc, vc, pos):
    """x (B,1,D); kc/vc (B,W,Hkv,hd), written in place at the slot of
    ``pos``. Returns y."""
    B, W = x.shape[0], kc.shape[1]
    posb = pos.expand(B, 1)
    q = L.apply_rope(_proj_heads(x, p["wq"]), posb, cfg.rope_theta)
    k = L.apply_rope(_proj_heads(x, p["wk"]), posb, cfg.rope_theta)
    v = _proj_heads(x, p["wv"])
    slot = pos % W if cfg.attn_kind == "swa" \
        else torch.clamp(pos, max=W - 1)
    idx = slot.reshape(1).long()
    kc.index_copy_(1, idx, k)
    vc.index_copy_(1, idx, v)
    ar = torch.arange(W, device=x.device)[None, :]
    valid = ar <= pos      # a ring: all valid once pos >= W
    if cfg.attn_kind == "swa":
        valid = valid | (pos >= W)
    o = L.decode_attention(q, kc, vc, valid.expand(B, W))
    return _proj_out(o, p["wo"])


def decode_step(params: Tree, cfg: ModelConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B,) -> (logits (B,V) f32, cache). Updates ``cache`` in place
    and returns it with ``pos`` advanced by one."""
    x = params["embed"][tokens][:, None, :]
    pos = cache["pos"]
    hd = cfg.resolved_head_dim
    for i, lp in enumerate(params["layers"]):
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        if cfg.family == "ssm":
            H = cfg.d_model // hd
            y, S1, xtm = RWKV.time_mix(h, cache["x_tm"][i], cache["S"][i],
                                       lp["tm"], H, hd)
            cache["S"][i].copy_(S1)
            cache["x_tm"][i].copy_(xtm)
            x = x + y
            h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
            y, xcm = RWKV.channel_mix(h, cache["x_cm"][i], lp["cm"])
            cache["x_cm"][i].copy_(xcm)
            x = x + y
            continue
        a = _decode_attn(h, lp["attn"], cfg, cache["k"][i], cache["v"][i],
                         pos)
        if cfg.family == "hybrid":
            s, st = SSM.mamba_head(
                h, lp["mamba"], {"h": cache["ssm_h"][i],
                                 "conv": cache["conv"][i]},
                hd, cfg.ssm.state_size)
            cache["ssm_h"][i].copy_(st["h"])
            cache["conv"][i].copy_(st["conv"])
            a = _mix_heads(a, s, lp, cfg)
        x = x + a
        x = x + _ffn(L.rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg)[0]
    cache["pos"] = pos + 1
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)[:, 0]
    return h.float() @ _emb_out(params).float().T, cache

