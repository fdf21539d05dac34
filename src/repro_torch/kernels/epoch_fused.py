"""The fused fork--execute epoch (``csrc/epoch_fused.cu``).

Replaces ``repro/kernels/epoch_fused.py``'s ``epoch_fused``: for the
specialised ``run_sim`` families ``"pc"`` (pcstall, accpc) and
``"reactive"`` (stall/lead/crit/crisp, accreac), and for the
traced-mechanism-id family ``"fork"`` that the batched sweep steps, where
each grid row carries its mechanism as an id. One call runs a whole
epoch:

    context gathers -> predict (PC table or reactive state) -> select
    -> 11-way execute (NF uniform fork rows + the selected mixed row)
    -> barrier/contention counters (selected row) -> estimate
    -> table / reactive-state update

:func:`_epoch_math` is the plain PyTorch version of the body, op for op
the reference's. It has the reference's two math modes: ``lean=False``
orders every op as the unfused engine body; ``lean=True`` (the engine
default) reassociates the fork rows (epoch scale and noise factor folded
into one multiply, the intra-CU prefix sum as a tril matmul, the memory
blend as ``alloc - am (1-scale)``) and keeps the selected row, which
advances the program position, in the exact order.

The sin-hash noise ``eps`` rides in as an operand: ``frac(sin(x)*43758)``
turns one ulp of a differently computed ``x`` into O(1) noise, so the
kernel never recomputes it.

In the fork family every predictor and estimator is evaluated and the
row's id selects: ids below ``len(react_models) + 1`` predict from the
reactive CU state, the others from the PC table; the reactive state
advances by the id's counter model (``react_models`` in id order, the
fork-exact model last) and the table and per-WF state only for
``pc_ids`` (``id_ctr_pc`` counter-driven, the others fork-exact); every
other group keeps its carry values. ``hit_rate`` is emitted for every id.

On CUDA tensors every call is one call of the C entry point
(``csrc/epoch_fused.cu``), in one tiled form for every family: each row's
CUs cut over CTAs of a few CUs (the launcher picks the width from CU, R
and the card's SM count, each V/f domain whole in a CTA;
:func:`cta_width` reads its pick), a pass A (predict, select, per-CU
traffic partials), a pass B (execute, counters, state advance) and an
epilogue (table sums and EMA blend, hit rate). :func:`epoch_fused_rows`
steps R fork-family rows at once (the sweep's grid rows, each with its
own program, block count, id, sweep scalars and power regime);
:func:`epoch_fused` is the one-row call of every family. A row's bits
depend neither on its batch nor on its CTA width: every sum across CUs
runs in CU order. On CPU tensors the plain version runs row by row.

``block_cu`` is the reference's CU tiling of the fork family
(``_fork_blocked``): a divisor of CU that holds whole domains, checked as
the reference checks it, and otherwise inert on either device, as on the
reference's interpret engine (the families ``pc`` and ``reactive`` ignore
it, as the reference does). :func:`_fork_blocked_math` is the plain
version of the reference's blocked pair (lean math; traffic, hits and
raw table sums accumulated block by block in index order), reached
through :func:`epoch_fused_blocked_ref` and
:func:`epoch_fused_rows_blocked_ref`.

On a CUDA tensor the wrappers launch the CUDA kernels (calls counted in
``epoch_fused.launches`` and ``epoch_fused.launches_by_family``); on a CPU
tensor they run :func:`_epoch_math`. :func:`epoch_fused_ref` and
:func:`epoch_fused_rows_ref` run :func:`_epoch_math` on any device.
A program a CTA's shared memory cannot hold raises (``RuntimeError``
naming the remedy); nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import (any_id, clamp_blocks, clip, no_tf32, prog_len,
                         select_id)
from repro_torch.core import estimators as EST
from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.kernels import check, library, require, stream_ptr_of

_F32, _I32 = torch.float32, torch.int32
_N_SCAL = 9
_N_PW = len(PWR.PowerAxes._fields)
_CU_MODEL_IDS = {m: i for i, m in enumerate(EST.CU_MODELS)}
_FAMILY_IDS = {"pc": 0, "reactive": 1, "fork": 2}
# what the C entry point returns, before any launch, for a program (and a
# row's traffic partials) that a CTA's shared memory cannot hold
# (csrc/epoch_fused.cu: kRowTooWide)
_ROW_TOO_WIDE = -1


class EpochOut(NamedTuple):
    """One epoch of state advance + telemetry. Reactive-family calls leave
    the table fields ``None``; pc-family calls leave the reactive state
    ``None``; fork-family calls fill every field. :func:`epoch_fused_rows`
    returns each field with a leading row axis (``t_acc`` and ``hit_rate``
    as (R,))."""
    pos: torch.Tensor                    # (CU,WF) advanced wave positions
    table: Optional[PRED.PCTable]        # updated PC table (pc family)
    wf_i0: Optional[torch.Tensor]        # (CU,WF) per-WF estimates (pc)
    wf_sens: Optional[torch.Tensor]
    react_i0: Optional[torch.Tensor]     # (CU,) CU estimates (reactive)
    react_sens: Optional[torch.Tensor]
    f_sel: torch.Tensor                  # (CU,) executed GHz
    e_acc: torch.Tensor                  # (CU,) accumulated energy
    t_acc: torch.Tensor                  # (1,) accumulated time
    work: torch.Tensor                   # (CU,) committed work
    energy: torch.Tensor                 # (CU,) epoch energy
    err: torch.Tensor                    # (CU,) |pred - actual| / actual
    fidx: torch.Tensor                   # (CU,) int32 ladder index
    true_sens: torch.Tensor              # (CU,) fork-exact CU sensitivity
    hit_rate: Optional[torch.Tensor]     # (1,) table hit fraction (pc)


def _select(I_pred, eacc, tacc, F, pw, T, cap, w_pbar, use_rate, capf, *,
            WF, ND, CPD):
    """Per-domain frequency select (op order == ``_select_freq``): the
    first argmin of the Lagrangian cost over the ladder, for ND domains of
    CPD CUs. Returns (fidx, f_sel), each (ND * CPD,)."""
    NF = F.shape[0]
    pbar = (eacc / torch.clamp(tacc[0], min=1e-3)).reshape(ND, CPD).sum(1)
    I_dom = I_pred.reshape(ND, CPD, NF)
    act = I_pred / (cap * F[None, :] * T * WF)
    p_cu = PWR.power(F[None, :], act, pw)
    P_dom = p_cu.reshape(ND, CPD, NF).sum(1)
    I_sum = torch.clamp(I_dom.sum(1), min=1e-3)
    denom = torch.where(use_rate > 0.0, I_sum, 1.0)
    infeasible = I_sum < capf * I_sum[:, -1:]
    cost = (P_dom + w_pbar * pbar[:, None]) / denom + 1e9 * infeasible
    fidx = torch.argmin(cost, dim=-1)[:, None].expand(ND, CPD).reshape(-1)
    return fidx, F[fidx]


def _epoch_math(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, P, family,
                fork_estimator, cu_model, lean, react_models=(), pc_ids=(),
                id_ctr_pc=0):
    """The fused epoch body on tensors, in the operand/output order of
    :func:`epoch_fused` (one row). ``P`` is the logical block count, a
    Python int or a 0-dim tensor. In the fork family ``ins`` carries both
    state groups and the (0-dim) traced id ``mech``; ``react_models``,
    ``pc_ids`` and ``id_ctr_pc`` are the registry-derived id layout."""
    if family == "fork":
        (i0r, sr, cum_t, pos, ti0, tse, tcnt, wfi, wfs, ri0, rse, fprev,
         eacc, tacc, F, tid, mech, eps, scal, pw_vec) = ins
    elif family == "pc":
        (i0r, sr, cum_t, pos, ti0, tse, tcnt, wfi, wfs, fprev, eacc, tacc,
         F, tid, eps, scal, pw_vec) = ins
    else:
        (i0r, sr, cum_t, pos, ri0, rse, fprev, eacc, tacc, F, eps, scal,
         pw_vec) = ins
    pw = PWR.PowerAxes(*pw_vec.unbind(0))
    T, sigma, cap, membw, ema, w_pbar, use_rate, capf, lat = scal.unbind(0)

    # ---- context: shared gathers ------------------------------------------
    blk = torch.remainder(torch.div(pos.to(torch.int32), IPB,
                                    rounding_mode="floor"), P).long()
    i0_l = i0r[blk]
    s_l = sr[blk]
    c_i0, c_se, c_mf = cum_t[0], cum_t[1], cum_t[2]
    lo_i0 = c_i0[blk]
    lo_se = c_se[blk]
    lo_mf = c_mf[blk]

    # ---- predict I(f) from carry state ------------------------------------
    capr = cap * F[None, :] * T * WF
    hit_rate = None
    if family == "fork":
        # both predictor paths, selected on the traced mechanism id
        idx_lu = PRED.table_index(blk, E, OFFB)
        t = tid.long().clamp(0, T_ - 1)[:, None]
        hit = tcnt[t, idx_lu] > 0
        hit_rate = (hit.to(_F32).sum() / hit.numel()).reshape(1)
        i0_pc = torch.where(hit, ti0[t, idx_lu], wfi).sum(-1)
        s_pc = torch.where(hit, tse[t, idx_lu], wfs).sum(-1)
        I_pc = clip((i0_pc[:, None] + s_pc[:, None] * F[None, :]) * T, 0.0,
                    capr)
        I_react = clip((ri0[:, None] + rse[:, None] * F[None, :]) * T, 0.0,
                       capr)
        I_pred = torch.where(mech < len(react_models) + 1, I_react, I_pc)
    elif family == "pc":
        idx_lu = PRED.table_index(blk, E, OFFB)
        t = tid.long().clamp(0, T_ - 1)[:, None]
        hit = tcnt[t, idx_lu] > 0
        i0_cu = torch.where(hit, ti0[t, idx_lu], wfi).sum(-1)
        s_cu = torch.where(hit, tse[t, idx_lu], wfs).sum(-1)
        hit_rate = (hit.to(_F32).sum() / hit.numel()).reshape(1)
    else:
        i0_cu, s_cu = ri0, rse
    if family != "fork":
        I_pred = (i0_cu[:, None] + s_cu[:, None] * F[None, :]) * T
        I_pred = clip(I_pred, 0.0, capr)

    fidx, f_sel = _select(I_pred, eacc, tacc, F, pw, T, cap, w_pbar,
                          use_rate, capf, WF=WF, ND=ND, CPD=CPD)

    # ---- 11-way batched execute (op order == _steady_parts) --------------
    F_rows = F[:, None].expand(NF, CU)
    f_all = F_rows if lean else torch.cat([F_rows, f_sel[None]], 0)
    f_b = f_all[..., :, None]
    est_instr = (i0_l + s_l * f_b) * T
    nblk = clamp_blocks((est_instr / IPB).to(torch.int32) + 1, P).long()
    gi = blk + nblk
    nb = nblk.to(_F32)
    dci = c_i0[gi] - lo_i0
    dcs = c_se[gi] - lo_se
    i0w = dci / nb
    sw = dcs / nb
    mfw = (c_mf[gi] - lo_mf) / nb
    if lean:
        demand = (dci + dcs * f_b) * ((T * (1.0 + sigma * eps)) / nb)
    else:
        demand = (i0w + sw * f_b) * T
        demand = demand * (1.0 + sigma * eps)
    C = cap * f_all * T
    if lean:
        no_tf32()
        L = torch.tril(torch.ones((WF, WF), dtype=_F32, device=pos.device))
        before = torch.matmul(demand, L.T) - demand
    else:
        before = torch.cumsum(demand, -1) - demand
    alloc = clip(C[..., :, None] - before, 0.0, demand)
    am = alloc * mfw
    traffic = am.sum(dim=(-2, -1))
    scale = torch.clamp(membw * T / torch.clamp(traffic, min=1e-6), max=1.0)
    if lean:
        steady = alloc - am * (1.0 - scale[..., None, None])
    else:
        steady = alloc * (1.0 - mfw * (1.0 - scale[..., None, None]))
    c_f = steady[:NF]                   # (NF,CU,WF) fork rows
    I_f = c_f.sum(-1).T                 # (CU,NF)
    if lean:
        # the selected row: same shared gathers, reference op order
        est_s = (i0_l + s_l * f_sel[:, None]) * T
        nblk_s = clamp_blocks((est_s / IPB).to(torch.int32) + 1,
                               P).long()
        gi_s = blk + nblk_s
        nb_s = nblk_s.to(_F32)
        i0w_s = (c_i0[gi_s] - lo_i0) / nb_s
        sw_s = (c_se[gi_s] - lo_se) / nb_s
        mfw_s = (c_mf[gi_s] - lo_mf) / nb_s
        d_s = (i0w_s + sw_s * f_sel[:, None]) * T
        d_s = d_s * (1.0 + sigma * eps)
        C_s = cap * f_sel * T
        b_s = torch.cumsum(d_s, -1) - d_s
        a_s = clip(C_s[:, None] - b_s, 0.0, d_s)
        tr_s = (a_s * mfw_s).sum()
        sc_s = torch.clamp(membw * T / torch.clamp(tr_s, min=1e-6), max=1.0)
        st_sel = a_s * (1.0 - mfw_s * (1.0 - sc_s))
    else:
        i0w_s, sw_s, mfw_s = i0w[NF], sw[NF], mfw[NF]
        d_s, a_s = demand[NF], alloc[NF]
        st_sel = steady[NF]

    # ---- selected-row counters (op order == _row_counters) ---------------
    q = a_s / torch.clamp(d_s, min=1e-6)
    plen = prog_len(P, IPB)
    tentative = pos + st_sel
    group_min = tentative.amin(-1)
    boundary = (torch.floor(group_min / plen) + 1.0) * plen
    committed = torch.minimum(st_sel,
                              torch.clamp(boundary[:, None] - pos, min=0.0))
    core_frac = sw_s * f_sel[:, None] \
        / torch.clamp(i0w_s + sw_s * f_sel[:, None], min=1e-6)

    # ---- transition overhead, telemetry, energy ---------------------------
    trans = f_sel != fprev
    committed = committed * (1.0 - lat / T * trans[:, None])
    I_actual = st_sel.sum(-1)
    work = committed.sum(-1)
    I_at_sel = torch.gather(I_pred, 1, fidx[:, None])[:, 0]
    err = torch.abs(I_at_sel - I_actual) / torch.clamp(I_actual, min=1e-3)
    act_w = work / (cap * f_sel * T * WF)
    energy = PWR.power(f_sel, act_w, pw) * T \
        + PWR.transition_energy(fprev, f_sel, pw) * trans

    # ---- estimate + state update -----------------------------------------
    ctrs = {"committed": st_sel, "steady": st_sel, "core_frac": core_frac,
            "issue_q": q, "mem_frac": mfw_s}
    tsens = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
    if family == "fork":
        # every estimator variant, selected on the traced id (counter
        # models in id order, the fork-exact reactive model last)
        cu_ests = [EST.cu_estimate(ctrs, f_sel, m) for m in react_models]
        sens_ar = tsens                 # the fork-exact reactive model
        i0_ar = I_f[:, 0] / T - sens_ar * F[0]
        r_i0 = select_id(mech, [e[0] / T for e in cu_ests] + [i0_ar], ri0)
        r_se = select_id(mech, [e[1] / T for e in cu_ests] + [sens_ar], rse)
        i0_est, s_est = EST.wf_stall_estimate(ctrs, f_sel)
        s_tr = (c_f[-1] - c_f[0]) / (F[-1] - F[0])
        i0_tr = c_f[0] - s_tr * F[0]
        i0_wf = torch.where(mech == id_ctr_pc, i0_est, i0_tr) / T
        s_wf = torch.where(mech == id_ctr_pc, s_est, s_tr) / T
        tbl0 = PRED.PCTable(ti0, tse, tcnt)
        tbl_u = PRED.table_update(tbl0, tid, idx_lu, i0_wf, s_wf, ema)
        pc_now = any_id(mech, pc_ids)
        tbl = [torch.where(pc_now, a, b) for a, b in zip(tbl_u, tbl0)]
        state = (*tbl, torch.where(pc_now, i0_wf, wfi),
                 torch.where(pc_now, s_wf, wfs), r_i0, r_se)
    elif family == "pc":
        if fork_estimator:              # accpc: exact per-WF linear model
            s_wf = (c_f[-1] - c_f[0]) / (F[-1] - F[0])
            i0_wf = c_f[0] - s_wf * F[0]
        else:                           # pcstall: counter-driven
            i0_wf, s_wf = EST.wf_stall_estimate(ctrs, f_sel)
        i0_wf, s_wf = i0_wf / T, s_wf / T
        tbl = PRED.table_update(PRED.PCTable(ti0, tse, tcnt), tid, idx_lu,
                                i0_wf, s_wf, ema)
        state = (tbl.i0, tbl.sens, tbl.count, i0_wf, s_wf)
    else:
        if fork_estimator:              # accreac: exact linear from forks
            s_est = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
            i0_est = I_f[:, 0] / T - s_est * F[0]
        else:                           # counter model (stall/lead/...)
            i0_c, s_c = EST.cu_estimate(ctrs, f_sel, cu_model)
            i0_est, s_est = i0_c / T, s_c / T
        state = (i0_est, s_est)

    outs = (pos + committed,) + state + (
        f_sel, eacc + energy, (tacc + T).reshape(1), work, energy, err,
        fidx.to(_I32), tsens)
    if family in ("pc", "fork"):
        outs = outs + (hit_rate,)
    return outs


def _check_blocks(CU: int, block_cu: int, cus_per_domain: int) -> None:
    """The reference's tiling: whole blocks of whole domains."""
    if block_cu < 1 or CU % block_cu or block_cu % cus_per_domain:
        raise ValueError(f"block_cu={block_cu} must divide n_cu={CU} and be "
                         f"a multiple of cus_per_domain={cus_per_domain}")


def _fork_blocked_math(ins, *, NF, CU, WF, E, T_, CPD, IPB, OFFB, P,
                       block_cu, react_models, pc_ids, id_ctr_pc, **_):
    """The reference's blocked fork epoch (``_fork_blk_a``, ``_fork_blk_b``
    and the ``_fork_blocked`` epilogue) on tensors, one row, in the
    operand/output order of :func:`_epoch_math` (family ``fork``).

    Blocks of ``block_cu`` CUs run in index order. Pass A predicts and
    selects per block (each domain lies whole inside one block, so the
    select is exact) and accumulates the global traffic of the 11 execute
    rows and the hit count; pass B re-derives each block's execute, applies
    the global traffic scale, advances the block's state and accumulates
    the raw per-table (i0, sens, count) sums; the epilogue blends the
    sums into the table. Every execute row, the selected one included,
    runs the lean math (the reference's blocked pair implements no other).
    The remaining keywords of :func:`_epoch_math` are accepted and
    unused."""
    (i0r, sr, cum_t, pos, ti0, tse, tcnt, wfi, wfs, ri0, rse, fprev, eacc,
     tacc, F, tid, mech, eps, scal, pw_vec) = ins
    pw = PWR.PowerAxes(*pw_vec.unbind(0))
    T, sigma, cap, membw, ema, w_pbar, use_rate, capf, lat = scal.unbind(0)
    c_i0, c_se, c_mf = cum_t[0], cum_t[1], cum_t[2]
    n_react = len(react_models) + 1
    blocks = [slice(b, b + block_cu) for b in range(0, CU, block_cu)]
    no_tf32()
    L = torch.tril(torch.ones((WF, WF), dtype=_F32, device=pos.device))

    def execute(b, f_sel):
        """Block ``b``'s 11-way execute in lean math, down to the
        allocation (the same code in both passes, as in the reference)."""
        blk = torch.remainder(torch.div(pos[b].to(torch.int32), IPB,
                                        rounding_mode="floor"), P).long()
        i0_l, s_l = i0r[blk], sr[blk]
        lo_i0, lo_se, lo_mf = c_i0[blk], c_se[blk], c_mf[blk]
        f_all = torch.cat([F[:, None].expand(NF, block_cu), f_sel[None]], 0)
        f_b = f_all[..., :, None]
        est_instr = (i0_l + s_l * f_b) * T
        nblk = clamp_blocks((est_instr / IPB).to(torch.int32) + 1, P).long()
        gi = blk + nblk
        nb = nblk.to(_F32)
        dci = c_i0[gi] - lo_i0
        dcs = c_se[gi] - lo_se
        mfw = (c_mf[gi] - lo_mf) / nb
        demand = (dci + dcs * f_b) * ((T * (1.0 + sigma * eps[b])) / nb)
        C = cap * f_all * T
        before = torch.matmul(demand, L.T) - demand
        alloc = clip(C[..., :, None] - before, 0.0, demand)
        return blk, dict(alloc=alloc, demand=demand, mfw=mfw, i0w=dci / nb,
                         sw=dcs / nb, am=alloc * mfw)

    # ---- pass A: predict + select per block, global traffic and hits ----
    capr = cap * F[None, :] * T * WF
    traffic = torch.zeros(NF + 1, dtype=_F32, device=pos.device)
    hit_sum = torch.zeros(1, dtype=_F32, device=pos.device)
    sel = []
    for b in blocks:
        blk = torch.remainder(torch.div(pos[b].to(torch.int32), IPB,
                                        rounding_mode="floor"), P).long()
        idx_lu = PRED.table_index(blk, E, OFFB)
        t = tid[b].long().clamp(0, T_ - 1)[:, None]
        hit = tcnt[t, idx_lu] > 0
        i0_pc = torch.where(hit, ti0[t, idx_lu], wfi[b]).sum(-1)
        s_pc = torch.where(hit, tse[t, idx_lu], wfs[b]).sum(-1)
        I_pc = clip((i0_pc[:, None] + s_pc[:, None] * F[None, :]) * T, 0.0,
                    capr)
        I_react = clip((ri0[b][:, None] + rse[b][:, None] * F[None, :]) * T,
                       0.0, capr)
        I_pred = torch.where(mech < n_react, I_react, I_pc)
        fidx, f_sel = _select(I_pred, eacc[b], tacc, F, pw, T, cap, w_pbar,
                              use_rate, capf, WF=WF, ND=block_cu // CPD,
                              CPD=CPD)
        _, ex = execute(b, f_sel)
        traffic = traffic + ex["am"].sum(dim=(-2, -1))
        hit_sum = hit_sum + hit.to(_F32).sum().reshape(1)
        sel.append((fidx, f_sel, torch.gather(I_pred, 1,
                                              fidx[:, None])[:, 0]))

    # ---- pass B: execute + counters + state per block, raw table sums ----
    scale = torch.clamp(membw * T / torch.clamp(traffic, min=1e-6), max=1.0)
    plen = prog_len(P, IPB)
    pc_now = any_id(mech, pc_ids)
    agg = [torch.zeros((T_, E), dtype=_F32, device=pos.device)
           for _ in range(3)]
    outs = []
    for b, (fidx, f_sel, I_at_sel) in zip(blocks, sel):
        blk, ex = execute(b, f_sel)
        alloc, demand, mfw = ex["alloc"], ex["demand"], ex["mfw"]
        i0w, sw = ex["i0w"], ex["sw"]
        steady = alloc - ex["am"] * (1.0 - scale[..., None, None])
        c_f = steady[:NF]
        I_f = c_f.sum(-1).T
        st_sel = steady[NF]
        q = alloc[NF] / torch.clamp(demand[NF], min=1e-6)
        tentative = pos[b] + st_sel
        boundary = (torch.floor(tentative.amin(-1) / plen) + 1.0) * plen
        committed = torch.minimum(
            st_sel, torch.clamp(boundary[:, None] - pos[b], min=0.0))
        core_frac = sw[NF] * f_sel[:, None] \
            / torch.clamp(i0w[NF] + sw[NF] * f_sel[:, None], min=1e-6)
        trans = f_sel != fprev[b]
        committed = committed * (1.0 - lat / T * trans[:, None])
        I_actual = st_sel.sum(-1)
        work = committed.sum(-1)
        err = torch.abs(I_at_sel - I_actual) \
            / torch.clamp(I_actual, min=1e-3)
        act_w = work / (cap * f_sel * T * WF)
        energy = PWR.power(f_sel, act_w, pw) * T \
            + PWR.transition_energy(fprev[b], f_sel, pw) * trans
        ctrs = {"committed": st_sel, "steady": st_sel,
                "core_frac": core_frac, "issue_q": q, "mem_frac": mfw[NF]}
        tsens = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
        cu_ests = [EST.cu_estimate(ctrs, f_sel, m) for m in react_models]
        i0_ar = I_f[:, 0] / T - tsens * F[0]
        r_i0 = select_id(mech, [e[0] / T for e in cu_ests] + [i0_ar], ri0[b])
        r_se = select_id(mech, [e[1] / T for e in cu_ests] + [tsens], rse[b])
        i0_est, s_est = EST.wf_stall_estimate(ctrs, f_sel)
        s_tr = (c_f[-1] - c_f[0]) / (F[-1] - F[0])
        i0_tr = c_f[0] - s_tr * F[0]
        i0_wf = torch.where(mech == id_ctr_pc, i0_est, i0_tr) / T
        s_wf = torch.where(mech == id_ctr_pc, s_est, s_tr) / T
        sums = PRED.slot_sums(tid[b], PRED.table_index(blk, E, OFFB), i0_wf,
                              s_wf, T_, E)
        agg = [a + x for a, x in zip(agg, sums)]
        outs.append((pos[b] + committed, torch.where(pc_now, i0_wf, wfi[b]),
                     torch.where(pc_now, s_wf, wfs[b]), r_i0, r_se, f_sel,
                     eacc[b] + energy, work, energy, err, fidx.to(_I32),
                     tsens))

    # ---- epilogue: EMA blend of the global sums, pc gate, accumulators ---
    tbl0 = PRED.PCTable(ti0, tse, tcnt)
    tbl = [torch.where(pc_now, a, b)
           for a, b in zip(PRED.ema_blend(tbl0, *agg, ema), tbl0)]
    (pos_n, wfi_n, wfs_n, r_i0, r_se, f_sel, eacc_n, work, energy, err, fidx,
     tsens) = (torch.cat(col) for col in zip(*outs))
    return (pos_n, *tbl, wfi_n, wfs_n, r_i0, r_se, f_sel, eacc_n,
            (tacc + T).reshape(1), work, energy, err, fidx, tsens,
            (hit_sum / (CU * WF)).reshape(1))


class _EpochArgs(ctypes.Structure):
    """Mirror of ``struct EpochArgs`` in ``csrc/epoch_fused.cu``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "i0r", "sr", "cum_t", "pos", "eps", "ti0", "tse", "tcnt", "tid",
        "wfi", "wfs", "ri0", "rse", "fprev", "eacc", "tacc", "F", "scal",
        "pw", "prow", "Prow", "mech", "pos_o", "ti0_o", "tse_o", "tcnt_o",
        "wfi_o", "wfs_o", "ri0_o", "rse_o", "fsel_o", "eacc_o", "tacc_o",
        "work_o", "energy_o", "err_o", "fidx_o", "tsens_o", "hit_o")] + [
            (n, ctypes.c_int) for n in (
                "P", "Pp", "CU", "WF", "NF", "T", "E", "CPD", "IPB", "OFFB",
                "family", "fork_est", "cu_model", "lean", "R", "n_react",
                "react_models", "pc_mask", "id_ctr_pc")] + [
            (n, ctypes.c_void_p) for n in ("traf", "hit_cu", "idx",
                                           "iat")] + [
            ("cta_cu", ctypes.c_int)]


# what to do about it: every CTA holds the whole program, which no tiling
# shrinks
_TOO_WIDE_HINT = ("every CTA holds the whole program, so no block_cu "
                  "(SimConfig.pallas_block_cu) helps: use a program of fewer "
                  "blocks")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run_kernel(args: _EpochArgs, dev: torch.device, family: str) -> None:
    """Call the C entry point once on ``dev``'s current stream (passes A
    and B, and the epilogue but for the reactive family) and count it
    under ``family``."""
    code = library().epoch_fused_launch(ctypes.addressof(args),
                                        stream_ptr_of(dev))
    if code == _ROW_TOO_WIDE:
        raise RuntimeError(
            f"epoch_fused[{family}]: {args.CU} CUs x {args.WF} WFs over "
            f"{args.Pp} program blocks do not fit a CTA's shared memory: "
            f"{_TOO_WIDE_HINT}")
    check(code, f"epoch_fused[{family}]")
    epoch_fused.launches += 1
    epoch_fused.launches_by_family[family] += 1


def cta_width(CU: int, R: int, cus_per_domain: int = 1) -> int:
    """The CTA width, in CUs, that the launcher picks for ``R`` rows of
    ``CU`` CUs on the current CUDA device."""
    return int(library().epoch_fused_cta_width(CU, R, cus_per_domain))


# the execute rows the kernels run per CU: fork rows 0 and NF-1 and the
# selected row, the only ones any output reads (csrc/epoch_fused.cu)
_EXEC_ROWS = 3


def _scratch(R, CU, WF, dev, table: bool):
    """The passes' hand-over buffers: per-CU traffic partials of the
    executed rows and I at the selected state, and (with a table) per-CU
    hit counts and each WF's table slot."""
    out = dict(traf=torch.empty((R, _EXEC_ROWS, CU), dtype=_F32, device=dev),
               iat=torch.empty((R, CU), dtype=_F32, device=dev))
    if table:
        out.update(hit_cu=torch.empty((R, CU), dtype=_I32, device=dev),
                   idx=torch.empty((R, CU, WF), dtype=_I32, device=dev))
    return out


def _launch(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, P, family,
            fork_estimator, cu_model, lean):
    """Check the operands and launch K3; same outputs as
    :func:`_epoch_math`."""
    pc = family == "pc"
    if pc:
        (i0r, sr, cum_t, pos, ti0, tse, tcnt, wfi, wfs, fprev, eacc, tacc,
         F, tid, eps, scal, pw_vec) = ins
        ri0 = rse = None
    else:
        (i0r, sr, cum_t, pos, ri0, rse, fprev, eacc, tacc, F, eps, scal,
         pw_vec) = ins
        ti0 = tse = tcnt = wfi = wfs = tid = None
    if WF > 64 or NF > 32:
        raise ValueError(f"epoch_fused kernel takes WF <= 64 and NF <= 32, "
                         f"got WF={WF}, NF={NF}")
    dev = pos.device
    Pp = i0r.shape[0]
    if not 1 <= P <= Pp:
        raise ValueError(f"p_blocks={P} outside the program's {Pp} blocks")
    checks = [("i0_rate", i0r, _F32, (Pp,)), ("sens_rate", sr, _F32, (Pp,)),
              ("cum_t", cum_t, _F32, (3, 2 * Pp + 1)),
              ("pos", pos, _F32, (CU, WF)), ("eps", eps, _F32, (CU, WF)),
              ("f_prev", fprev, _F32, (CU,)), ("e_acc", eacc, _F32, (CU,)),
              ("t_acc", tacc, _F32, (1,)), ("freqs", F, _F32, (NF,)),
              ("scal", scal, _F32, (_N_SCAL,)),
              ("power", pw_vec, _F32, (len(PWR.PowerAxes._fields),))]
    if pc:
        checks += [("table.i0", ti0, _F32, (T_, E)),
                   ("table.sens", tse, _F32, (T_, E)),
                   ("table.count", tcnt, _F32, (T_, E)),
                   ("tid", tid, _I32, (CU,)), ("wf_i0", wfi, _F32, (CU, WF)),
                   ("wf_sens", wfs, _F32, (CU, WF))]
    else:
        checks += [("react_i0", ri0, _F32, (CU,)),
                   ("react_sens", rse, _F32, (CU,))]
    for name, t, dt, shp in checks:
        require(t, name, dt, shp, dev)

    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    o = dict(pos_o=empty(CU, WF), fsel_o=empty(CU), eacc_o=empty(CU),
             tacc_o=empty(1), work_o=empty(CU), energy_o=empty(CU),
             err_o=empty(CU), fidx_o=empty(CU, dtype=_I32),
             tsens_o=empty(CU))
    if pc:
        o.update(ti0_o=empty(T_, E), tse_o=empty(T_, E), tcnt_o=empty(T_, E),
                 wfi_o=empty(CU, WF), wfs_o=empty(CU, WF), hit_o=empty(1))
    else:
        o.update(ri0_o=empty(CU), rse_o=empty(CU))

    scratch = _scratch(1, CU, WF, dev, pc)
    args = _EpochArgs(
        i0r=_ptr(i0r), sr=_ptr(sr), cum_t=_ptr(cum_t), pos=_ptr(pos),
        eps=_ptr(eps), ti0=_ptr(ti0), tse=_ptr(tse), tcnt=_ptr(tcnt),
        tid=_ptr(tid), wfi=_ptr(wfi), wfs=_ptr(wfs), ri0=_ptr(ri0),
        rse=_ptr(rse), fprev=_ptr(fprev), eacc=_ptr(eacc), tacc=_ptr(tacc),
        F=_ptr(F), scal=_ptr(scal), pw=_ptr(pw_vec),
        **{k: _ptr(v) for k, v in o.items()},
        **{k: _ptr(v) for k, v in scratch.items()},
        P=P, Pp=Pp, CU=CU, WF=WF, NF=NF, T=T_, E=E, CPD=CPD, IPB=IPB,
        OFFB=OFFB, family=_FAMILY_IDS[family], fork_est=int(fork_estimator),
        cu_model=_CU_MODEL_IDS.get(cu_model, -1), lean=int(lean), R=1)
    _run_kernel(args, dev, family)
    head = (o["pos_o"],)
    if pc:
        head += (o["ti0_o"], o["tse_o"], o["tcnt_o"], o["wfi_o"], o["wfs_o"])
    else:
        head += (o["ri0_o"], o["rse_o"])
    tail = (o["fsel_o"], o["eacc_o"], o["tacc_o"], o["work_o"],
            o["energy_o"], o["err_o"], o["fidx_o"], o["tsens_o"])
    return head + tail + ((o["hit_o"],) if pc else ())


def _as_f32(x, dev) -> torch.Tensor:
    """A float, 0-dim/1-d tensor or array as an f32 tensor on ``dev``
    (floats are filled on the device: no host-to-device copy)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=_F32, device=dev)
    return torch.as_tensor(x).to(device=dev, dtype=_F32)


def _pack_scal(epoch_us, sigma, cap_per_ghz, membw, table_ema, obj, lat_us,
               device) -> torch.Tensor:
    """Pack the sweep scalars into one (9,) f32 operand: [epoch_us, sigma,
    cap_per_ghz, membw, table_ema, obj0, obj1, obj2, lat_us]."""
    return torch.cat([
        torch.stack([_as_f32(x, device) for x in
                     (epoch_us, sigma, cap_per_ghz, membw, table_ema)]),
        _as_f32(obj, device).reshape(3), _as_f32(lat_us, device).reshape(1)])


def _pack_power(power, device) -> torch.Tensor:
    """A ``PowerAxes``/``PowerConfig`` as the (11,) f32 power operand."""
    return torch.stack([_as_f32(getattr(power, f), device)
                        for f in PWR.PowerAxes._fields])


def _fork_layout(react_models, pc_ids, id_ctr_pc):
    """The registry-derived id layout as the kernel's four ints: reactive
    id count, counter models packed four bits per id, pc-id bit mask, the
    counter-driven pc id."""
    n_react = len(react_models) + 1
    if n_react > 8 or any(not 0 <= i < 31 for i in pc_ids):
        raise ValueError(f"fork layout out of the kernel's range: "
                         f"{len(react_models)} counter models, pc ids "
                         f"{tuple(pc_ids)}")
    packed = 0
    for i, m in enumerate(react_models):
        if m not in _CU_MODEL_IDS:
            raise ValueError(f"react model {m!r} not one of {EST.CU_MODELS}")
        packed |= _CU_MODEL_IDS[m] << (4 * i)
    return n_react, packed, sum(1 << i for i in pc_ids), int(id_ctr_pc)


def _launch_rows(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, lean,
                 react_models, pc_ids, id_ctr_pc, block_cu=None):
    """Check the operands of R fork rows (and ``block_cu``, which picks
    nothing) and call the kernels ONCE (passes A and B over (CU / cta_cu,
    R) CTAs, then the epilogue), counted under ``"fork"``. Same outputs as
    :func:`_rows_plain`."""
    (i0r, sr, cum_t, prow, Prow, pos, ti0, tse, tcnt, wfi, wfs, ri0, rse,
     fprev, eacc, tacc, F, tid, mech, eps, scal, pw_vec) = ins
    if WF > 64 or NF > 32:
        raise ValueError(f"epoch_fused kernel takes WF <= 64 and NF <= 32, "
                         f"got WF={WF}, NF={NF}")
    dev = pos.device
    R = pos.shape[0]
    W, Pp = i0r.shape
    checks = [("i0_rate", i0r, _F32, (W, Pp)), ("sens_rate", sr, _F32, (W, Pp)),
              ("cum_t", cum_t, _F32, (W, 3, 2 * Pp + 1)),
              ("prog_idx", prow, _I32, (R,)), ("p_blocks", Prow, _I32, (R,)),
              ("pos", pos, _F32, (R, CU, WF)), ("eps", eps, _F32, (R, CU, WF)),
              ("table.i0", ti0, _F32, (R, T_, E)),
              ("table.sens", tse, _F32, (R, T_, E)),
              ("table.count", tcnt, _F32, (R, T_, E)),
              ("wf_i0", wfi, _F32, (R, CU, WF)),
              ("wf_sens", wfs, _F32, (R, CU, WF)),
              ("react_i0", ri0, _F32, (R, CU)),
              ("react_sens", rse, _F32, (R, CU)),
              ("f_prev", fprev, _F32, (R, CU)), ("e_acc", eacc, _F32, (R, CU)),
              ("t_acc", tacc, _F32, (R,)), ("freqs", F, _F32, (R, NF)),
              ("tid", tid, _I32, (CU,)), ("mech", mech, _I32, (R,)),
              ("scal", scal, _F32, (R, _N_SCAL)),
              ("power", pw_vec, _F32, (R, _N_PW))]
    for name, t, dt, shp in checks:
        require(t, name, dt, shp, dev)
    if block_cu is not None:
        _check_blocks(CU, block_cu, CPD)
    n_react, packed, pc_mask, ctr = _fork_layout(react_models, pc_ids,
                                                 id_ctr_pc)

    def empty(*shape, dtype=_F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    o = dict(pos_o=empty(R, CU, WF), ti0_o=empty(R, T_, E),
             tse_o=empty(R, T_, E), tcnt_o=empty(R, T_, E),
             wfi_o=empty(R, CU, WF), wfs_o=empty(R, CU, WF),
             ri0_o=empty(R, CU), rse_o=empty(R, CU), fsel_o=empty(R, CU),
             eacc_o=empty(R, CU), tacc_o=empty(R), work_o=empty(R, CU),
             energy_o=empty(R, CU), err_o=empty(R, CU),
             fidx_o=empty(R, CU, dtype=_I32), tsens_o=empty(R, CU),
             hit_o=empty(R))
    scratch = _scratch(R, CU, WF, dev, True)
    args = _EpochArgs(
        i0r=_ptr(i0r), sr=_ptr(sr), cum_t=_ptr(cum_t), pos=_ptr(pos),
        eps=_ptr(eps), ti0=_ptr(ti0), tse=_ptr(tse), tcnt=_ptr(tcnt),
        tid=_ptr(tid), wfi=_ptr(wfi), wfs=_ptr(wfs), ri0=_ptr(ri0),
        rse=_ptr(rse), fprev=_ptr(fprev), eacc=_ptr(eacc), tacc=_ptr(tacc),
        F=_ptr(F), scal=_ptr(scal), pw=_ptr(pw_vec), prow=_ptr(prow),
        Prow=_ptr(Prow), mech=_ptr(mech),
        **{k: _ptr(v) for k, v in o.items()},
        **{k: _ptr(v) for k, v in scratch.items()},
        P=Pp, Pp=Pp, CU=CU, WF=WF, NF=NF, T=T_, E=E, CPD=CPD, IPB=IPB,
        OFFB=OFFB, family=_FAMILY_IDS["fork"], fork_est=0, cu_model=-1,
        lean=int(lean), R=R, n_react=n_react, react_models=packed,
        pc_mask=pc_mask, id_ctr_pc=ctr)
    _run_kernel(args, dev, "fork")
    epoch_fused.fork_rows += R
    return tuple(o[k] for k in (
        "pos_o", "ti0_o", "tse_o", "tcnt_o", "wfi_o", "wfs_o", "ri0_o",
        "rse_o", "fsel_o", "eacc_o", "tacc_o", "work_o", "energy_o", "err_o",
        "fidx_o", "tsens_o", "hit_o"))


def _rows_plain(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, lean,
                react_models, pc_ids, id_ctr_pc, block_cu=None,
                blocked=False):
    """The one-row plain version mapped over the rows, one row at a time:
    each row's bits are those of a one-row call. ``blocked`` runs
    :func:`_fork_blocked_math` (tiles of ``block_cu`` CUs), else
    :func:`_epoch_math` (family ``fork``; ``block_cu`` inert)."""
    (i0r, sr, cum_t, prow, Prow, pos, ti0, tse, tcnt, wfi, wfs, ri0, rse,
     fprev, eacc, tacc, F, tid, mech, eps, scal, pw_vec) = ins
    math = _epoch_math
    if blocked:
        _check_blocks(CU, block_cu, CPD)
        if not lean:
            raise ValueError("the reference's blocked fork epoch implements "
                             "lean math only")
        math = functools.partial(_fork_blocked_math, block_cu=block_cu)
    per_row = []
    for r in range(pos.shape[0]):
        p = prow[r:r + 1].long()
        row = (i0r.index_select(0, p)[0], sr.index_select(0, p)[0],
               cum_t.index_select(0, p)[0], pos[r], ti0[r], tse[r], tcnt[r],
               wfi[r], wfs[r], ri0[r], rse[r], fprev[r], eacc[r],
               tacc[r:r + 1], F[r], tid, mech[r], eps[r], scal[r],
               pw_vec[r])
        per_row.append(math(
            row, NF=NF, CU=CU, WF=WF, E=E, T_=T_, ND=ND, CPD=CPD, IPB=IPB,
            OFFB=OFFB, P=Prow[r], family="fork", fork_estimator=False,
            cu_model=None, lean=lean, react_models=react_models,
            pc_ids=pc_ids, id_ctr_pc=id_ctr_pc))
    outs = [torch.stack(col) for col in zip(*per_row)]
    outs[10] = outs[10].reshape(-1)      # t_acc (R,)
    outs[16] = outs[16].reshape(-1)      # hit_rate (R,)
    return tuple(outs)


def _rows_blocked_plain(ins, **statics):
    return _rows_plain(ins, blocked=True, **statics)


def _fork_out(outs, squeeze: bool) -> EpochOut:
    (pos_n, ti0, tse, tcnt, wfi, wfs, ri0, rse, f_sel, eacc, tacc, work,
     energy, err, fidx, tsens, hit) = outs
    out = EpochOut(pos=pos_n, table=PRED.PCTable(ti0, tse, tcnt), wf_i0=wfi,
                   wf_sens=wfs, react_i0=ri0, react_sens=rse, f_sel=f_sel,
                   e_acc=eacc, t_acc=tacc, work=work, energy=energy, err=err,
                   fidx=fidx, true_sens=tsens, hit_rate=hit)
    if not squeeze:
        return out
    return EpochOut(*(PRED.PCTable(*(x[0] for x in v)) if isinstance(
        v, PRED.PCTable) else v[0] for v in out))._replace(
            t_acc=tacc.reshape(1), hit_rate=hit.reshape(1))


def _rows_call(engine, i0_rate, sens_rate, cum_t, prog_idx, pos, freqs, eps,
               f_prev, e_acc, t_acc, *, p_blocks, mech, scal, power, table,
               tid, wf_i0, wf_sens, react_i0, react_sens, cus_per_domain=1,
               offset_blocks=4, react_models=(), pc_ids=(), id_ctr_pc=0,
               block_cu=None, instr_per_block=4, lean=True):
    R, CU, WF = pos.shape
    NF = freqs.shape[-1]
    if CU % cus_per_domain:
        raise ValueError(f"n_cu={CU} not a multiple of cus_per_domain="
                         f"{cus_per_domain}")
    T_, E = table.i0.shape[-2:]
    operands = (i0_rate, sens_rate, cum_t, prog_idx, p_blocks, pos,
                table.i0, table.sens, table.count, wf_i0, wf_sens, react_i0,
                react_sens, f_prev, e_acc, t_acc, freqs, tid, mech, eps, scal,
                power)
    return engine(operands, NF=NF, CU=CU, WF=WF, E=E, T_=T_,
                  ND=CU // cus_per_domain, CPD=cus_per_domain,
                  IPB=instr_per_block, OFFB=offset_blocks, lean=lean,
                  react_models=tuple(react_models), pc_ids=tuple(pc_ids),
                  id_ctr_pc=id_ctr_pc, block_cu=block_cu)


def _rows_kernel_or_plain(ins, **statics):
    return (_launch_rows if ins[5].is_cuda else _rows_plain)(ins, **statics)


def epoch_fused_rows(i0_rate, sens_rate, cum_t, prog_idx, pos, freqs, eps,
                     f_prev, e_acc, t_acc, **kw) -> EpochOut:
    """Step R fork-family rows one epoch: on CUDA tensors ONE call of the
    kernels (three launches over the rows' CUs, counted once under
    ``launches_by_family["fork"]``), on CPU tensors the plain version row
    by row.

    ``i0_rate``/``sens_rate`` (W, Pp) and ``cum_t`` (W, 3, 2Pp+1) are W
    programs padded to Pp blocks; row r reads program ``prog_idx[r]``
    ((R,) int32) with logical block count ``p_blocks[r]`` ((R,) int32,
    in 1..Pp) and traced id ``mech[r]`` ((R,) int32). Per row: ``pos``,
    ``eps``, ``wf_i0``, ``wf_sens`` (R, CU, WF); ``f_prev``, ``e_acc``,
    ``react_i0``, ``react_sens`` (R, CU); ``t_acc`` (R,); ``freqs`` (R, NF)
    (the row's ladder); ``scal`` (R, 9) the packed sweep scalars
    [epoch_us, sigma, cap_per_ghz, membw, table_ema, obj0..2, lat_us];
    ``power`` (R, 11) the packed regime; ``table`` a ``PCTable`` of
    (R, T, E). ``tid`` (CU,) int32 is shared. ``react_models``,
    ``pc_ids``, ``id_ctr_pc`` give the id layout (see the module
    docstring). ``block_cu`` (the reference's tiling: a divisor of CU, a
    multiple of ``cus_per_domain``) is checked and otherwise inert."""
    return _fork_out(_rows_call(_rows_kernel_or_plain, i0_rate, sens_rate,
                                cum_t, prog_idx, pos, freqs, eps, f_prev,
                                e_acc, t_acc, **kw), squeeze=False)


def epoch_fused_rows_ref(i0_rate, sens_rate, cum_t, prog_idx, pos, freqs,
                         eps, f_prev, e_acc, t_acc, **kw) -> EpochOut:
    """:func:`epoch_fused_rows`' plain PyTorch version, on any device
    (``block_cu`` inert)."""
    return _fork_out(_rows_call(_rows_plain, i0_rate, sens_rate, cum_t,
                                prog_idx, pos, freqs, eps, f_prev, e_acc,
                                t_acc, **kw), squeeze=False)


def epoch_fused_rows_blocked_ref(i0_rate, sens_rate, cum_t, prog_idx, pos,
                                 freqs, eps, f_prev, e_acc, t_acc, *,
                                 block_cu: int, **kw) -> EpochOut:
    """The CU-tiled fork epoch's plain version (the reference's blocked
    pair, :func:`_fork_blocked_math`) over R rows, on any device; the
    operands of :func:`epoch_fused_rows`."""
    return _fork_out(_rows_call(_rows_blocked_plain, i0_rate, sens_rate,
                                cum_t, prog_idx, pos, freqs, eps, f_prev,
                                e_acc, t_acc, block_cu=block_cu, **kw),
                     squeeze=False)


def _epoch_call(engine, rows_engine, i0_rate, sens_rate, cum_t, pos, freqs,
                eps, f_prev, e_acc, t_acc, *, p_blocks, epoch_us, sigma,
                cap_per_ghz, membw, obj, lat_us, power, cus_per_domain=1,
                table=None, tid=None, wf_i0=None, wf_sens=None,
                table_ema=0.5, offset_blocks=4, react_i0=None,
                react_sens=None, mech=None, react_models=(), pc_ids=(),
                id_ctr_pc=0, block_cu=None, family="pc",
                fork_estimator=False, cu_model=None, instr_per_block=4,
                lean=True) -> EpochOut:
    if family not in ("pc", "reactive", "fork"):
        raise ValueError(f"family must be 'pc', 'reactive' or 'fork', got "
                         f"{family!r}")
    CU, WF = pos.shape
    NF = freqs.shape[0]
    if CU % cus_per_domain:
        raise ValueError(f"n_cu={CU} not a multiple of cus_per_domain="
                         f"{cus_per_domain}")
    if family == "reactive" and not fork_estimator \
            and cu_model not in EST.CU_MODELS:
        raise ValueError(f"cu_model must be one of {EST.CU_MODELS}, got "
                         f"{cu_model!r}")
    dev = pos.device
    scal = _pack_scal(epoch_us, sigma, cap_per_ghz, membw, table_ema, obj,
                      lat_us, dev)
    pw_vec = _pack_power(power, dev)
    tacc = t_acc.reshape(1) if isinstance(t_acc, torch.Tensor) \
        else _as_f32(t_acc, dev).reshape(1)
    if family == "fork":
        if mech is None:
            raise ValueError("family='fork' needs the traced id mech")
        one = torch.zeros((1,), dtype=_I32, device=dev)
        outs = _rows_call(
            rows_engine, i0_rate[None], sens_rate[None], cum_t[None], one,
            pos[None], freqs[None], eps[None], f_prev[None], e_acc[None],
            tacc, p_blocks=torch.full((1,), int(p_blocks), dtype=_I32,
                                      device=dev),
            mech=torch.as_tensor(mech).to(device=dev,
                                          dtype=_I32).reshape(1),
            scal=scal[None], power=pw_vec[None],
            table=PRED.PCTable(*(x[None] for x in table)), tid=tid,
            wf_i0=wf_i0[None], wf_sens=wf_sens[None],
            react_i0=react_i0[None], react_sens=react_sens[None],
            cus_per_domain=cus_per_domain, offset_blocks=offset_blocks,
            react_models=react_models, pc_ids=pc_ids, id_ctr_pc=id_ctr_pc,
            block_cu=block_cu, instr_per_block=instr_per_block, lean=lean)
        return _fork_out(outs, squeeze=True)
    if mech is not None:
        raise ValueError(f"mech is the fork family's operand, not "
                         f"{family!r}'s")
    if family == "pc":
        T_, E = table.i0.shape
        operands = (i0_rate, sens_rate, cum_t, pos, table.i0, table.sens,
                    table.count, wf_i0, wf_sens, f_prev, e_acc, tacc, freqs,
                    tid, eps, scal, pw_vec)
    else:
        T_, E = 0, 0
        operands = (i0_rate, sens_rate, cum_t, pos, react_i0, react_sens,
                    f_prev, e_acc, tacc, freqs, eps, scal, pw_vec)
    outs = engine(operands, NF=NF, CU=CU, WF=WF, E=E, T_=T_,
                  ND=CU // cus_per_domain, CPD=cus_per_domain,
                  IPB=instr_per_block, OFFB=offset_blocks, P=int(p_blocks),
                  family=family, fork_estimator=fork_estimator,
                  cu_model=cu_model, lean=lean)
    if family == "pc":
        (pos_n, ti0, tse, tcnt, wfi, wfs, f_sel, eacc, tacc, work, energy,
         err, fidx, tsens, hit) = outs
        return EpochOut(pos=pos_n, table=PRED.PCTable(ti0, tse, tcnt),
                        wf_i0=wfi, wf_sens=wfs, react_i0=None,
                        react_sens=None, f_sel=f_sel, e_acc=eacc,
                        t_acc=tacc, work=work, energy=energy, err=err,
                        fidx=fidx, true_sens=tsens, hit_rate=hit)
    (pos_n, ri0, rse, f_sel, eacc, tacc, work, energy, err, fidx,
     tsens) = outs
    return EpochOut(pos=pos_n, table=None, wf_i0=None, wf_sens=None,
                    react_i0=ri0, react_sens=rse, f_sel=f_sel, e_acc=eacc,
                    t_acc=tacc, work=work, energy=energy, err=err,
                    fidx=fidx, true_sens=tsens, hit_rate=None)


def _kernel_or_plain(ins, **statics):
    return (_launch if ins[3].is_cuda else _epoch_math)(ins, **statics)


def epoch_fused(i0_rate, sens_rate, cum_t, pos, freqs, eps, f_prev, e_acc,
                t_acc, **kw) -> EpochOut:
    """Run one fused fork--execute epoch of one simulation.

    ``i0_rate``/``sens_rate`` (P,) are the program rates; ``cum_t`` is the
    packed prefix table transposed to ``(3, 2P+1)``; ``eps`` the (CU,WF)
    epoch noise (``simulate._epoch_noise``). Keywords as in the reference:
    ``p_blocks`` (int), the sweep scalars ``epoch_us``, ``sigma``,
    ``cap_per_ghz``, ``membw``, ``obj`` (3,), ``lat_us``, ``table_ema``
    (floats or device tensors), ``power`` (``PowerAxes``/``PowerConfig``),
    ``cus_per_domain``, ``offset_blocks``; ``family='pc'`` needs
    ``table/tid/wf_i0/wf_sens``, ``family='reactive'`` needs
    ``react_i0/react_sens`` and ``cu_model`` unless ``fork_estimator``;
    ``family='fork'`` needs both state groups, the traced id ``mech`` and
    the id layout ``react_models``/``pc_ids``/``id_ctr_pc`` (a one-row
    :func:`epoch_fused_rows`; ``block_cu`` as there, ignored by the other
    families). ``lean`` picks the math mode (see the module docstring).

    On CUDA tensors this launches the kernels (f32 operands, ``tid``
    int32, all contiguous; WF <= 64, NF <= 32) and never synchronises; on
    CPU tensors it runs the plain version."""
    return _epoch_call(_kernel_or_plain, _rows_kernel_or_plain, i0_rate,
                       sens_rate, cum_t, pos, freqs, eps, f_prev, e_acc,
                       t_acc, **kw)


epoch_fused.launches = 0
epoch_fused.launches_by_family = {"pc": 0, "reactive": 0, "fork": 0}
# rows stepped by the fork-family launches (rows per launch = this over
# launches_by_family["fork"])
epoch_fused.fork_rows = 0


def epoch_fused_ref(i0_rate, sens_rate, cum_t, pos, freqs, eps, f_prev,
                    e_acc, t_acc, **kw) -> EpochOut:
    """:func:`epoch_fused`'s plain PyTorch version, on any device."""
    return _epoch_call(_epoch_math, _rows_plain, i0_rate, sens_rate, cum_t,
                       pos, freqs, eps, f_prev, e_acc, t_acc, **kw)


def epoch_fused_blocked_ref(i0_rate, sens_rate, cum_t, pos, freqs, eps,
                            f_prev, e_acc, t_acc, *, block_cu: int,
                            **kw) -> EpochOut:
    """The CU-tiled fork epoch's plain version for one row, on any device:
    the operands of :func:`epoch_fused` with ``family="fork"``."""
    if kw.get("family") != "fork":
        raise ValueError("the blocked epoch is the fork family's")
    return _epoch_call(_epoch_math, _rows_blocked_plain, i0_rate, sens_rate,
                       cum_t, pos, freqs, eps, f_prev, e_acc, t_acc,
                       block_cu=block_cu, **kw)
