"""The fused fork--execute epoch (``csrc/epoch_fused.cu``).

Replaces ``repro/kernels/epoch_fused.py``'s ``epoch_fused`` for the
specialised ``run_sim`` families ``"pc"`` (pcstall, accpc) and
``"reactive"`` (stall/lead/crit/crisp, accreac). One call runs a whole
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

On a CUDA tensor :func:`epoch_fused` launches the CUDA kernel (counted in
``epoch_fused.launches``); on a CPU tensor it runs :func:`_epoch_math`.
:func:`epoch_fused_ref` runs :func:`_epoch_math` on any device.

Not ported yet: ``family="fork"`` (the traced-mechanism-id mode serving
the batched sweep) and its CU-blocked variant (``block_cu``); see ROADMAP
queue B.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import clip, no_tf32
from repro_torch.core import estimators as EST
from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.kernels import check, library, require, stream_ptr

_F32, _I32 = torch.float32, torch.int32
_N_SCAL = 9
_CU_MODEL_IDS = {m: i for i, m in enumerate(EST.CU_MODELS)}
_FORK_TODO = ("family='fork' and block_cu (the traced-id sweep kernel and "
              "its CU-blocked variant) are not ported yet: ROADMAP queue B "
              "items K4 and K5")


class EpochOut(NamedTuple):
    """One epoch of state advance + telemetry. Reactive-family calls leave
    the table fields ``None``; pc-family calls leave the reactive state
    ``None``."""
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



def _epoch_math(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, P, family,
                fork_estimator, cu_model, lean):
    """The fused epoch body on tensors, in the operand/output order of
    :func:`epoch_fused` (families ``pc`` and ``reactive``)."""
    if family == "pc":
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
    if family == "pc":
        idx_lu = PRED.table_index(blk, E, OFFB)
        t = tid.long().clamp(0, T_ - 1)[:, None]
        hit = tcnt[t, idx_lu] > 0
        i0_cu = torch.where(hit, ti0[t, idx_lu], wfi).sum(-1)
        s_cu = torch.where(hit, tse[t, idx_lu], wfs).sum(-1)
        hit_rate = (hit.to(_F32).sum() / hit.numel()).reshape(1)
    else:
        i0_cu, s_cu = ri0, rse
    I_pred = (i0_cu[:, None] + s_cu[:, None] * F[None, :]) * T
    I_pred = clip(I_pred, 0.0, capr)

    # ---- per-domain frequency select (op order == _select_freq) ----------
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
    f_sel = F[fidx]

    # ---- 11-way batched execute (op order == _steady_parts) --------------
    F_rows = F[:, None].expand(NF, CU)
    f_all = F_rows if lean else torch.cat([F_rows, f_sel[None]], 0)
    f_b = f_all[..., :, None]
    est_instr = (i0_l + s_l * f_b) * T
    nblk = torch.clamp((est_instr / IPB).to(torch.int32) + 1, 1, P).long()
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
        nblk_s = torch.clamp((est_s / IPB).to(torch.int32) + 1, 1, P).long()
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
    plen = float(P * IPB)
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
    if family == "pc":
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
    if family == "pc":
        outs = outs + (hit_rate,)
    return outs


class _EpochArgs(ctypes.Structure):
    """Mirror of ``struct EpochArgs`` in ``csrc/epoch_fused.cu``."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "i0r", "sr", "cum_t", "pos", "eps", "ti0", "tse", "tcnt", "tid",
        "wfi", "wfs", "ri0", "rse", "fprev", "eacc", "tacc", "F", "scal",
        "pw", "pos_o", "ti0_o", "tse_o", "tcnt_o", "wfi_o", "wfs_o", "ri0_o",
        "rse_o", "fsel_o", "eacc_o", "tacc_o", "work_o", "energy_o", "err_o",
        "fidx_o", "tsens_o", "hit_o")] + [(n, ctypes.c_int) for n in (
            "P", "Pp", "CU", "WF", "NF", "T", "E", "CPD", "IPB", "OFFB",
            "family", "fork_est", "cu_model", "lean")]


def _launch(ins, *, NF, CU, WF, E, T_, ND, CPD, IPB, OFFB, P, family,
            fork_estimator, cu_model, lean):
    """Check the operands and launch the CUDA kernel; same outputs as
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _EpochArgs(
        i0r=ptr(i0r), sr=ptr(sr), cum_t=ptr(cum_t), pos=ptr(pos),
        eps=ptr(eps), ti0=ptr(ti0), tse=ptr(tse), tcnt=ptr(tcnt),
        tid=ptr(tid), wfi=ptr(wfi), wfs=ptr(wfs), ri0=ptr(ri0),
        rse=ptr(rse), fprev=ptr(fprev), eacc=ptr(eacc), tacc=ptr(tacc),
        F=ptr(F), scal=ptr(scal), pw=ptr(pw_vec),
        **{k: ptr(v) for k, v in o.items()},
        P=P, Pp=Pp, CU=CU, WF=WF, NF=NF, T=T_, E=E, CPD=CPD, IPB=IPB,
        OFFB=OFFB, family=0 if pc else 1, fork_est=int(fork_estimator),
        cu_model=_CU_MODEL_IDS.get(cu_model, -1), lean=int(lean))
    code = library().epoch_fused_launch(ctypes.addressof(args),
                                        stream_ptr(pos))
    epoch_fused.launches += 1
    epoch_fused.launches_by_family[family] += 1
    check(code, "epoch_fused")
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


def _epoch_call(engine, i0_rate, sens_rate, cum_t, pos, freqs, eps, f_prev,
                e_acc, t_acc, *, p_blocks, epoch_us, sigma, cap_per_ghz,
                membw, obj, lat_us, power, cus_per_domain=1, table=None,
                tid=None, wf_i0=None, wf_sens=None, table_ema=0.5,
                offset_blocks=4, react_i0=None, react_sens=None, mech=None,
                block_cu=None, family="pc", fork_estimator=False,
                cu_model=None, instr_per_block=4, lean=True) -> EpochOut:
    if family == "fork" or mech is not None or block_cu is not None:
        raise NotImplementedError(_FORK_TODO)
    if family not in ("pc", "reactive"):
        raise ValueError(f"family must be 'pc' or 'reactive', got {family!r}")
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
    """Run one fused fork--execute epoch (families ``pc``/``reactive``).

    ``i0_rate``/``sens_rate`` (P,) are the program rates; ``cum_t`` is the
    packed prefix table transposed to ``(3, 2P+1)``; ``eps`` the (CU,WF)
    epoch noise (``simulate._epoch_noise``). Keywords as in the reference:
    ``p_blocks`` (int), the sweep scalars ``epoch_us``, ``sigma``,
    ``cap_per_ghz``, ``membw``, ``obj`` (3,), ``lat_us``, ``table_ema``
    (floats or device tensors), ``power`` (``PowerAxes``/``PowerConfig``),
    ``cus_per_domain``, ``offset_blocks``; ``family='pc'`` needs
    ``table/tid/wf_i0/wf_sens``, ``family='reactive'`` needs
    ``react_i0/react_sens`` and ``cu_model`` unless ``fork_estimator``.
    ``lean`` picks the math mode (see the module docstring).

    On CUDA tensors this launches the kernel (f32 operands, ``tid`` int32,
    all contiguous; WF <= 64, NF <= 32) and never synchronises; on CPU
    tensors it runs the plain version."""
    return _epoch_call(_kernel_or_plain, i0_rate, sens_rate, cum_t, pos,
                       freqs, eps, f_prev, e_acc, t_acc, **kw)


epoch_fused.launches = 0
epoch_fused.launches_by_family = {"pc": 0, "reactive": 0}


def epoch_fused_ref(i0_rate, sens_rate, cum_t, pos, freqs, eps, f_prev,
                    e_acc, t_acc, **kw) -> EpochOut:
    """:func:`epoch_fused`'s plain PyTorch version, on any device."""
    return _epoch_call(_epoch_math, i0_rate, sens_rate, cum_t, pos, freqs,
                       eps, f_prev, e_acc, t_acc, **kw)
