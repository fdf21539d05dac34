"""Plain PyTorch versions of the PC-table kernel pair (device-agnostic).

They are what ``pc_table.pc_table_predict``/``pc_table_update`` run on a
CPU tensor, and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import predictors as PRED


def pc_table_predict_ref(table_i0: torch.Tensor, table_sens: torch.Tensor,
                         table_count: torch.Tensor, tid: torch.Tensor,
                         idx: torch.Tensor, fb_i0: torch.Tensor,
                         fb_sens: torch.Tensor, freqs: torch.Tensor, *,
                         epoch_us=1.0, cap_per_ghz=0.0) -> torch.Tensor:
    """PCSTALL lookup + per-CU aggregation + I(f) evaluation (+ capacity
    clip when ``cap_per_ghz > 0``). table_* (T,E); tid (CU,); idx/fb_*
    (CU,WF); freqs (F,). Returns I_pred (CU,F). Table ids and slots clamp
    into range, as the reference's gathers do."""
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
    return torch.where(cap > 0.0, clipped, ipred)


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
