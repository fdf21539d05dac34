"""PCSTALL PC-table kernels: predict and update (``csrc/pc_table.cu``).

Replace ``repro/kernels/pc_table.py``'s ``pc_table_predict`` and
``pc_table_update`` Pallas kernels. On a CUDA tensor each wrapper checks
its operands in one pass and launches its kernel on the current stream
(no sync), and nothing else runs on the card: ``idx`` is read as int32 or
int64, a scalar on the card is read through its pointer and a Python
float (or a CPU tensor) is passed by value. On a CPU tensor it runs the
plain version in ``kernels/ref.py``. Each wrapper counts its kernel
launches in a ``launches`` attribute.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import check, library, require, stream_ptr
from repro_torch.kernels import ref

_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
_IDX = (_I32, _I64)
Scalar = Union[float, torch.Tensor]


def _operands(ops, dev: int) -> None:
    """Check ``(tensor, name, dtype, shape)`` operands against CUDA device
    ``dev``: one cheap test each, ``require``'s message on a mismatch."""
    for t, name, dt, shp in ops:
        if (t.dtype is not dt or t.shape != shp or t.get_device() != dev
                or not t.is_contiguous()):
            require(t, name, dt, shp, torch.device("cuda", dev))


def _index(idx: torch.Tensor, shp, dev: int) -> int:
    """Check the slot operand (int32 or int64); 1 where it is int64."""
    if idx.dtype not in _IDX:
        raise ValueError(f"idx: dtype {idx.dtype}, expected torch.int32 or "
                         "torch.int64")
    _operands(((idx, "idx", idx.dtype, shp),), dev)
    return int(idx.dtype is _I64)


def _scalar(x: Scalar, name: str, dev: int):
    """(pointer, value) of a scalar operand: a one-element f32 tensor on
    the card by its pointer, a float or a one-element CPU tensor by
    value."""
    if not isinstance(x, torch.Tensor):
        return None, float(x)
    if x.numel() != 1 or (x.is_cuda and (x.dtype is not _F32
                                         or x.get_device() != dev)):
        raise ValueError(f"{name}: a one-element f32 tensor on cuda:{dev}, "
                         f"a one-element CPU tensor or a float, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return (x.data_ptr(), 0.0) if x.is_cuda else (None, float(x))


def pc_table_predict(tbl_i0: torch.Tensor, tbl_sens: torch.Tensor,
                     tbl_cnt: torch.Tensor, tid: torch.Tensor,
                     idx: torch.Tensor, fb_i0: torch.Tensor,
                     fb_sens: torch.Tensor, freqs: torch.Tensor, *,
                     epoch_us: Scalar = 1.0, cap_per_ghz: Scalar = 0.0,
                     return_hit: bool = False):
    """tbl_* (T,E) f32; tid (CU,) i32; idx (CU,WF) i32 or i64; fb_* (CU,WF)
    f32; freqs (F,) f32 with F <= 32; ``epoch_us``/``cap_per_ghz`` floats
    or one-element f32 tensors. Returns I_pred (CU,F) =
    (sum_wf i0 + sum_wf sens * f) * epoch_us, capacity-clipped to
    cap*f*epoch_us*WF when ``cap_per_ghz > 0``. A miss (count 0) falls back
    to the WF's own estimate; table ids and slots clamp into range. With
    ``return_hit``, returns (I_pred, hit): hit (CU,WF) f32 is 1 where the
    WF's slot has a count > 0."""
    if not idx.is_cuda:
        return ref.pc_table_predict_ref(tbl_i0, tbl_sens, tbl_cnt, tid, idx,
                                        fb_i0, fb_sens, freqs,
                                        epoch_us=epoch_us,
                                        cap_per_ghz=cap_per_ghz,
                                        return_hit=return_hit)
    dev = idx.get_device()
    CU, WF = idx.shape
    T, E = tbl_i0.shape
    NF = freqs.shape[0]
    if NF > 32:
        raise ValueError(f"pc_table_predict takes at most 32 states, got {NF}")
    idx64 = _index(idx, (CU, WF), dev)
    _operands(((tbl_i0, "tbl_i0", _F32, (T, E)),
               (tbl_sens, "tbl_sens", _F32, (T, E)),
               (tbl_cnt, "tbl_cnt", _F32, (T, E)), (tid, "tid", _I32, (CU,)),
               (fb_i0, "fb_i0", _F32, (CU, WF)),
               (fb_sens, "fb_sens", _F32, (CU, WF)),
               (freqs, "freqs", _F32, (NF,))), dev)
    ep_p, ep_v = _scalar(epoch_us, "epoch_us", dev)
    cap_p, cap_v = _scalar(cap_per_ghz, "cap_per_ghz", dev)
    out = torch.empty((CU, NF), dtype=_F32, device=idx.device)
    hit = (torch.empty((CU, WF), dtype=_F32, device=idx.device)
           if return_hit else None)
    code = library().pc_table_predict_launch(
        tbl_i0.data_ptr(), tbl_sens.data_ptr(), tbl_cnt.data_ptr(),
        tid.data_ptr(), idx.data_ptr(), fb_i0.data_ptr(), fb_sens.data_ptr(),
        freqs.data_ptr(), ep_p, cap_p, ep_v, cap_v, idx64, CU, WF, T, E, NF,
        out.data_ptr(), None if hit is None else hit.data_ptr(),
        stream_ptr(idx))
    pc_table_predict.launches += 1
    check(code, "pc_table_predict")
    return (out, hit) if return_hit else out


pc_table_predict.launches = 0


def pc_table_update(tbl_i0: torch.Tensor, tbl_sens: torch.Tensor,
                    tbl_cnt: torch.Tensor, idx: torch.Tensor,
                    i0: torch.Tensor, sens: torch.Tensor, *,
                    ema: Scalar = 0.5
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-table update. tbl_* (T,E) f32; idx (T,N) i32 or i64 and
    i0/sens (T,N) f32 grouped per table (N = wavefronts feeding that
    table: the contiguous CU->table layout); ``ema`` a float or a
    one-element f32 tensor. Collisions within the epoch are averaged in
    index order, then EMA-blended (a fresh slot is replaced); a slot off
    the table drops. Returns the new (i0, sens, count): three contiguous
    views of one (3,T,E) buffer."""
    if not idx.is_cuda:
        return ref.pc_table_update_ref(tbl_i0, tbl_sens, tbl_cnt, idx, i0,
                                       sens, ema=ema)
    dev = idx.get_device()
    T, E = tbl_i0.shape
    N = idx.shape[-1]
    idx64 = _index(idx, (T, N), dev)
    _operands(((tbl_i0, "tbl_i0", _F32, (T, E)),
               (tbl_sens, "tbl_sens", _F32, (T, E)),
               (tbl_cnt, "tbl_cnt", _F32, (T, E)),
               (i0, "i0", _F32, (T, N)), (sens, "sens", _F32, (T, N))), dev)
    ema_p, ema_v = _scalar(ema, "ema", dev)
    out = torch.empty((3, T, E), dtype=_F32, device=idx.device)
    code = library().pc_table_update_launch(
        tbl_i0.data_ptr(), tbl_sens.data_ptr(), tbl_cnt.data_ptr(),
        idx.data_ptr(), i0.data_ptr(), sens.data_ptr(), ema_p, ema_v, idx64,
        T, E, N, out.data_ptr(), stream_ptr(idx))
    pc_table_update.launches += 1
    check(code, "pc_table_update")
    return out.unbind(0)


pc_table_update.launches = 0
