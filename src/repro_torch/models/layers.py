"""Shared model layers: RMSNorm, RoPE, SwiGLU, attention (port of
``repro.models.layers``).

``attention`` computes what the reference's block-wise jnp attention
computes for a causal, sliding-window or prefix-LM prompt (the vision
frontend: every position sees the first ``prefix_len``), through the
flash-attention kernel K6 (``kernels.ops.flash_attention``): the kernel on
a CUDA tensor, its plain version on a CPU tensor. Where a window and a
prefix meet at S > ``q_block`` the reference's sliding-window path hides
prefix keys older than its key slice; K6 keeps every prefix key visible,
as the reference's other paths do. The reference's ``_mha_block`` and
``_causal_pair_attention`` are its jnp route to the same function and are
not ported; the reference rounds softmax probabilities to the value dtype
before the second product (``_mha_block``), K6 keeps them in f32 (in
bf16 through two bf16 terms, ``p_hi + p_lo``, to 2^-17). ``attention``
is differentiable (K6's forward, its backward in PyTorch operations).
``chunked_ce_loss`` is training's cross-entropy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs          # (..., S, hd//2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              prefix_len: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Hkv,hd). ``window > 0``: each query sees the
    previous ``window`` keys; ``prefix_len > 0``: the first ``prefix_len``
    positions are seen by every query (prefix-LM). Keys are walked in
    blocks of 128 (of the largest common divisor of S and 128 where 128
    does not divide S)."""
    S = q.shape[1]
    blk = min(128, S) if S % min(128, S) == 0 else math.gcd(S, 128)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len, blk_k=blk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-token decode in f32. q (B,1,H,hd), caches (B,W,Hkv,hd),
    valid (B,W) bool."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    B, W = valid_mask.shape
    Hkv = k_cache.shape[2]
    H = q.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    scores = torch.einsum("bhrd,bkhd->bhrk", qg.float(),
                          k_cache.float()) * scale
    scores = torch.where(valid_mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def _ce_chunk(x: torch.Tensor, emb_out: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The masked NLL sum of one chunk: x (B,c,D) and emb_out (V,D) f32."""
    logits = x.float() @ emb_out.T
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_ce_loss(x: torch.Tensor, emb_out: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """x (B,S,D) final hidden; emb_out (V,D); labels/mask (B,S), mask f32.

    The mean softmax cross-entropy over the masked positions (the count
    taken as at least 1), in f32, over sequence chunks of ``chunk`` (S
    where that does not divide S), as the reference scans them. Each
    chunk runs under a non-reentrant checkpoint when grad is enabled, so
    its (B, chunk, V) logits are recomputed in the backward and the
    (tokens x V) logits never exist whole in either pass."""
    B, S, D = x.shape
    if S % chunk:
        chunk = S
    w = emb_out.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        args = (x[:, sl], w, labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            nll = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll = _ce_chunk(*args)
        tot = tot + nll
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)
