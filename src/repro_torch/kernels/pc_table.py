"""PCSTALL PC-table kernels: predict and update (``csrc/pc_table.cu``).

Replace ``repro/kernels/pc_table.py``'s ``pc_table_predict`` and
``pc_table_update`` Pallas kernels. On a CUDA tensor each wrapper checks
its operands and launches its kernel on the current stream (no sync); on
a CPU tensor it runs the plain version in ``kernels/ref.py``. Each
wrapper counts its kernel launches in a ``launches`` attribute.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import check, library, require, stream_ptr
from repro_torch.kernels import ref

_F32, _I32 = torch.float32, torch.int32


def _scalar(x, dev) -> torch.Tensor:
    """A float or 0-dim tensor as a (1,) f32 tensor on ``dev``, without a
    host-to-device copy for floats."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=_F32).reshape(1)
    return torch.full((1,), x, dtype=_F32, device=dev)


def pc_table_predict(tbl_i0: torch.Tensor, tbl_sens: torch.Tensor,
                     tbl_cnt: torch.Tensor, tid: torch.Tensor,
                     idx: torch.Tensor, fb_i0: torch.Tensor,
                     fb_sens: torch.Tensor, freqs: torch.Tensor, *,
                     epoch_us=1.0, cap_per_ghz=0.0) -> torch.Tensor:
    """tbl_* (T,E) f32; tid (CU,) i32; idx (CU,WF) i32; fb_* (CU,WF) f32;
    freqs (F,) f32 with F <= 32. Returns I_pred (CU,F) =
    (sum_wf i0 + sum_wf sens * f) * epoch_us, capacity-clipped to
    cap*f*epoch_us*WF when ``cap_per_ghz > 0``. A miss (count 0) falls back
    to the WF's own estimate; table ids and slots clamp into range."""
    if not idx.is_cuda:
        return ref.pc_table_predict_ref(tbl_i0, tbl_sens, tbl_cnt, tid, idx,
                                        fb_i0, fb_sens, freqs,
                                        epoch_us=epoch_us,
                                        cap_per_ghz=cap_per_ghz)
    dev = idx.device
    CU, WF = idx.shape
    T, E = tbl_i0.shape
    NF = freqs.shape[0]
    if NF > 32:
        raise ValueError(f"pc_table_predict takes at most 32 states, got {NF}")
    for name, t, dt, shp in (
            ("tbl_i0", tbl_i0, _F32, (T, E)), ("tbl_sens", tbl_sens, _F32,
                                                (T, E)),
            ("tbl_cnt", tbl_cnt, _F32, (T, E)), ("tid", tid, _I32, (CU,)),
            ("idx", idx, _I32, (CU, WF)), ("fb_i0", fb_i0, _F32, (CU, WF)),
            ("fb_sens", fb_sens, _F32, (CU, WF)),
            ("freqs", freqs, _F32, (NF,))):
        require(t, name, dt, shp, dev)
    scal = torch.cat([_scalar(epoch_us, dev), _scalar(cap_per_ghz, dev)])
    out = torch.empty((CU, NF), dtype=_F32, device=dev)
    code = library().pc_table_predict_launch(
        tbl_i0.data_ptr(), tbl_sens.data_ptr(), tbl_cnt.data_ptr(),
        tid.data_ptr(), idx.data_ptr(), fb_i0.data_ptr(), fb_sens.data_ptr(),
        freqs.data_ptr(), scal.data_ptr(), CU, WF, T, E, NF,
        out.data_ptr(), stream_ptr(out))
    pc_table_predict.launches += 1
    check(code, "pc_table_predict")
    return out


pc_table_predict.launches = 0


def pc_table_update(tbl_i0: torch.Tensor, tbl_sens: torch.Tensor,
                    tbl_cnt: torch.Tensor, idx: torch.Tensor,
                    i0: torch.Tensor, sens: torch.Tensor, *, ema=0.5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-table update. tbl_* (T,E) f32; idx (T,N) i32 and i0/sens (T,N)
    f32 grouped per table (N = wavefronts feeding that table: the
    contiguous CU->table layout). Collisions within the epoch are averaged
    in index order, then EMA-blended (a fresh slot is replaced). Returns
    the new (i0, sens, count)."""
    if not idx.is_cuda:
        return ref.pc_table_update_ref(tbl_i0, tbl_sens, tbl_cnt, idx, i0,
                                       sens, ema=ema)
    dev = idx.device
    T, E = tbl_i0.shape
    Tn, N = idx.shape
    for name, t, dt, shp in (
            ("tbl_i0", tbl_i0, _F32, (T, E)), ("tbl_sens", tbl_sens, _F32,
                                                (T, E)),
            ("tbl_cnt", tbl_cnt, _F32, (T, E)), ("idx", idx, _I32, (T, N)),
            ("i0", i0, _F32, (T, N)), ("sens", sens, _F32, (T, N))):
        require(t, name, dt, shp, dev)
    ema_t = _scalar(ema, dev)
    outs = tuple(torch.empty((T, E), dtype=_F32, device=dev)
                 for _ in range(3))
    code = library().pc_table_update_launch(
        tbl_i0.data_ptr(), tbl_sens.data_ptr(), tbl_cnt.data_ptr(),
        idx.data_ptr(), i0.data_ptr(), sens.data_ptr(), ema_t.data_ptr(),
        *(o.data_ptr() for o in outs), T, E, N, stream_ptr(ema_t))
    pc_table_update.launches += 1
    check(code, "pc_table_update")
    return outs


pc_table_update.launches = 0
