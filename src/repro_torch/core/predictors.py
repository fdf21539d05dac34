"""PC-indexed sensitivity table (port of ``repro.core.predictors``).

One table per ``cus_per_table`` CUs, ``entries`` slots, each slot a running
(i0, sens) estimate for the epoch that *starts* at that PC. Lookup uses
every wavefront's next starting PC; update folds this epoch's per-WF
estimates back keyed by its starting PC.

Gather semantics follow the reference: table ids are clamped into range on
lookup, and an out-of-range table id contributes nothing on update. The
update sums collisions with a one-hot contraction, never with float atomics
or ``index_add_``, so it is deterministic on every device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import DeviceLike, no_tf32, resolve_device


class PCTable(NamedTuple):
    i0: torch.Tensor     # (n_tables, entries)
    sens: torch.Tensor   # (n_tables, entries)
    count: torch.Tensor  # (n_tables, entries) update count (0 = invalid)


def table_init(n_tables: int, entries: int,
               device: DeviceLike = "cpu") -> PCTable:
    dev = resolve_device(device)
    return PCTable(*(torch.zeros((n_tables, entries), dtype=torch.float32,
                                 device=dev) for _ in range(3)))


def table_index(block: torch.Tensor, entries: int,
                offset_blocks: int) -> torch.Tensor:
    """PC -> table slot (``offset_blocks`` blocks per entry)."""
    return torch.remainder(torch.div(block, offset_blocks,
                                     rounding_mode="floor"), entries)


def slot_sums(tid: torch.Tensor, idx: torch.Tensor, i0: torch.Tensor,
              sens: torch.Tensor, n_tables: int, entries: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot (i0 sum, sens sum, count) of one epoch's updates, each
    (n_tables, entries). ``tid`` (CU,), ``idx``/``i0``/``sens`` (CU, WF).
    One-hot contraction: a CU whose table id is out of range matches no
    table row and drops."""
    no_tf32()  # one-hot products must keep the values' full f32 mantissa
    slots = torch.arange(entries, device=idx.device)
    oh = (idx[..., None] == slots).to(torch.float32)          # (CU,WF,E)
    vals = torch.stack([i0, sens, torch.ones_like(i0)], -1)   # (CU,WF,3)
    scat = torch.bmm(oh.transpose(1, 2), vals)                 # (CU,E,3)
    tables = torch.arange(n_tables, device=tid.device)
    t1h = (tid[None, :] == tables[:, None]).to(torch.float32)  # (T,CU)
    agg = (t1h @ scat.reshape(scat.shape[0], entries * 3)) \
        .reshape(n_tables, entries, 3)
    return agg[..., 0], agg[..., 1], agg[..., 2]


def ema_blend(tbl: PCTable, isum, ssum, cnt, ema) -> PCTable:
    """Collision average of the epoch's sums, EMA-blended into ``tbl``
    (a fresh slot is replaced, an untouched slot keeps its value)."""
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    one = torch.ones((), dtype=torch.float32, device=cnt.device)
    touched = cnt > 0
    snew = torch.where(touched, ssum / torch.clamp(cnt, min=1), zero)
    inew = torch.where(touched, isum / torch.clamp(cnt, min=1), zero)
    fresh = (tbl.count == 0) & touched
    blend = torch.where(fresh, one, torch.where(touched, ema, zero))
    return PCTable(
        i0=tbl.i0 * (1 - blend) + inew * blend,
        sens=tbl.sens * (1 - blend) + snew * blend,
        count=tbl.count + cnt,
    )


def table_update(tbl: PCTable, tid: torch.Tensor, idx: torch.Tensor,
                 i0: torch.Tensor, sens: torch.Tensor, ema=0.5) -> PCTable:
    """Fold per-WF estimates into the table. tid (CU,), idx/i0/sens
    (CU,WF). Collisions within an epoch are averaged; across epochs
    EMA-blended."""
    n_tables, entries = tbl.i0.shape
    isum, ssum, cnt = slot_sums(tid, idx, i0, sens, n_tables, entries)
    return ema_blend(tbl, isum, ssum, cnt, ema)


def table_lookup(tbl: PCTable, tid: torch.Tensor, idx: torch.Tensor,
                 fb_i0: torch.Tensor, fb_sens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-WF lookup with reactive fallback on miss. Returns (i0, sens,
    hit) each (CU,WF)."""
    t = tid.clamp(0, tbl.i0.shape[0] - 1)[:, None]
    hit = tbl.count[t, idx] > 0
    return (torch.where(hit, tbl.i0[t, idx], fb_i0),
            torch.where(hit, tbl.sens[t, idx], fb_sens),
            hit.to(torch.float32))
