"""Plain PyTorch oracles of the kernels (device-agnostic).

The PC-table pair: what ``pc_table.pc_table_predict``/``pc_table_update``
run on a CPU tensor, and what their CUDA kernels are held against on the
card. ``attention_ref`` (full softmax) and ``rwkv_chunk_ref`` (the exact
token scan) are the ground truths of the flash-attention and chunked-WKV
kernels, as ``repro/kernels/ref.py``'s are of the Pallas ones.
"""
from __future__ import annotations

import torch

from repro_torch.core import predictors as PRED


def pc_table_predict_ref(table_i0: torch.Tensor, table_sens: torch.Tensor,
                         table_count: torch.Tensor, tid: torch.Tensor,
                         idx: torch.Tensor, fb_i0: torch.Tensor,
                         fb_sens: torch.Tensor, freqs: torch.Tensor, *,
                         epoch_us=1.0, cap_per_ghz=0.0, return_hit=False):
    """PCSTALL lookup + per-CU aggregation + I(f) evaluation (+ capacity
    clip when ``cap_per_ghz > 0``). table_* (T,E); tid (CU,); idx/fb_*
    (CU,WF); freqs (F,). Returns I_pred (CU,F), and with ``return_hit``
    also the per-WF hit mask (CU,WF) f32 (1 where the slot's count > 0).
    Table ids and slots clamp into range, as the reference's gathers do."""
    T, E = table_i0.shape
    t = tid.clamp(0, T - 1)[:, None]
    e = idx.clamp(0, E - 1)
    hit = table_count[t, e] > 0
    i0 = torch.where(hit, table_i0[t, e], fb_i0)
    sens = torch.where(hit, table_sens[t, e], fb_sens)
    n_wf = idx.shape[1]
    ipred = (i0.sum(-1)[:, None]
             + sens.sum(-1)[:, None] * freqs[None, :]) * epoch_us
    cap = torch.as_tensor(cap_per_ghz, dtype=torch.float32,
                          device=ipred.device)
    clipped = torch.clamp(ipred, min=torch.zeros_like(ipred),
                          max=cap * freqs[None, :] * epoch_us * n_wf)
    ipred = torch.where(cap > 0.0, clipped, ipred)
    return (ipred, hit.to(torch.float32)) if return_hit else ipred


def pc_table_update_ref(table_i0: torch.Tensor, table_sens: torch.Tensor,
                        table_count: torch.Tensor, idx: torch.Tensor,
                        i0: torch.Tensor, sens: torch.Tensor, *, ema=0.5):
    """Collision-averaged per-slot update + EMA blend, per table instance.
    table_* (T,E); idx/i0/sens (T,N) grouped per table. Returns the new
    (i0, sens, count)."""
    T, E = table_i0.shape
    tid = torch.arange(T, device=idx.device)
    isum, ssum, cnt = PRED.slot_sums(tid, idx, i0, sens, T, E)
    return tuple(PRED.ema_blend(
        PRED.PCTable(table_i0, table_sens, table_count), isum, ssum, cnt,
        ema))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-softmax attention in f32. q (B,S,H,hd), k/v (B,S,Hkv,hd) with
    H % Hkv == 0. Returns (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, hd).float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float())
    scores = scores / (hd ** 0.5)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = kj <= qi if causal else torch.ones((S, S), dtype=torch.bool,
                                              device=q.device)
    if window:
        mask = mask & (kj > qi - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def rwkv_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor):
    """Exact RWKV6 recurrence, token by token, one head. r,k,v,w (T,hd)
    f32; u (hd,); S0 (hd,hd). Returns (y (T,hd), S_T)."""
    S = S0
    ys = []
    for t in range(r.shape[0]):
        a = torch.outer(k[t], v[t])
        ys.append(r[t] @ (S + u[:, None] * a))
        S = w[t][:, None] * S + a
    return torch.stack(ys), S
