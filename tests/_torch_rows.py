"""Operands of the fork-family epoch for R mixed rows (not collected: no
``test_`` prefix). Made from a seed with numpy and free of JAX, so the
CPU parity tests and the card-only tests build the same rows.

Rows mix traced ids, programs of different logical lengths padded to one
block count, sweep scalars (epoch length, noise, EMA, objective) and power
regimes."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.core import simulate as SIM
from repro_torch.core.sweep import pad_program
from repro_torch.core.workloads import make_program

# the registry-derived id layout of the traced family
LAYOUT = dict(react_models=SIM._REACT_MODELS, pc_ids=SIM._PC_IDS,
              id_ctr_pc=SIM._ID_CTR_PC)
# one regime per row, cycled: the default point and a narrower, hotter one
_REGIMES = (dict(), dict(f_max=2.0, c_eff=1.1, lat_per_us=8e-3))


def fork_rows_case(ids, CU, WF, *, NF=10, T=4, E=32, Ps=(96, 64, 80),
                   objectives=("ed2p",), cus_per_domain=1, tid=None,
                   offset_blocks=4, device="cpu", seed=0):
    """(args, kw) for ``epoch_fused_rows``: one row per traced id in
    ``ids``, over len(Ps) programs (kinds mixed/phased/memory) padded to
    max(Ps) blocks. ``tid`` defaults to CU % T."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    R = len(ids)
    kinds = ("mixed", "phased", "memory", "irregular")
    progs = [make_program(f"p{i}", kinds[i % 4], 5 + i, P=P, device="cpu")
             for i, P in enumerate(Ps)]
    Pp = max(Ps)
    padded = [pad_program(p, Pp) for p in progs]
    prog_idx = rng.integers(0, len(Ps), R).astype(np.int32)
    p_blocks = np.asarray(Ps, np.int32)[prog_idx]
    F, scal, pw = [], [], []
    for r in range(R):
        regime = PWR.PowerConfig(n_freqs=NF, **_REGIMES[r % 2])
        obj = SIM.objective_weights(objectives[r % len(objectives)])
        epoch_us = float(rng.choice([1.0, 2.0, 10.0]))
        F.append(PWR.freqs_ghz(regime, NF).numpy())
        lat = PWR.transition_latency_us(epoch_us, regime)
        scal.append([epoch_us, float(rng.choice([0.06, 0.1])), 5500.0,
                     160_000.0 * float(rng.choice([1.0, 0.05])),
                     float(rng.choice([0.5, 0.3])), *obj, lat])
        pw.append([getattr(regime, f) for f in PWR.PowerAxes._fields])
    F = np.asarray(F, np.float32)
    pos = np.stack([rng.uniform(0, P * 4 * 3, (CU, WF))
                    for P in p_blocks]).astype(np.float32)
    tid = np.arange(CU) % T if tid is None else np.asarray(tid)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    pos_t = f32(pos)
    eps = SIM._epoch_noise(pos_t, i32(p_blocks)[:, None, None],
                           i32(rng.integers(0, 5, R))[:, None, None])
    args = (f32(torch.stack([p.i0_rate for p in padded])),
            f32(torch.stack([p.sens_rate for p in padded])),
            f32(torch.stack([p.cum3.T for p in padded])),
            i32(prog_idx), pos_t, f32(F), eps.contiguous(),
            f32(F[np.arange(R)[:, None], rng.integers(0, NF, (R, CU))]),
            f32(rng.uniform(0, 5, (R, CU))), f32(rng.uniform(2, 30, R)))
    kw = dict(p_blocks=i32(p_blocks), mech=i32(ids), scal=f32(scal),
              power=f32(pw),
              table=PRED.PCTable(f32(rng.uniform(0, 60, (R, T, E))),
                                 f32(rng.uniform(0, 40, (R, T, E))),
                                 f32(rng.integers(0, 3, (R, T, E)))),
              tid=i32(tid), wf_i0=f32(rng.uniform(0, 60, (R, CU, WF))),
              wf_sens=f32(rng.uniform(0, 40, (R, CU, WF))),
              react_i0=f32(rng.uniform(0, 900, (R, CU))),
              react_sens=f32(rng.uniform(0, 500, (R, CU))),
              cus_per_domain=cus_per_domain, offset_blocks=offset_blocks,
              **LAYOUT)
    return args, kw


def row_fields(out, r=None):
    """An ``EpochOut`` (or its row ``r``) as {name: tensor on the CPU}."""
    res = {}
    for name in out._fields:
        v = getattr(out, name)
        if v is None:
            continue
        if name == "table":
            for k in ("i0", "sens", "count"):
                t = getattr(v, k)
                res[f"table.{k}"] = (t if r is None else t[r]).cpu()
        else:
            res[name] = (v if r is None else v[r]).cpu()
    return res


def one_row(args, kw, r):
    """Row ``r`` of a rows case as a one-row ``epoch_fused_rows`` call."""
    a = tuple(x[r:r + 1] if i not in (0, 1, 2) else x
              for i, x in enumerate(args))
    k = dict(kw)
    for name in ("p_blocks", "mech", "scal", "power", "wf_i0", "wf_sens",
                 "react_i0", "react_sens"):
        k[name] = kw[name][r:r + 1]
    k["table"] = type(kw["table"])(*(t[r:r + 1] for t in kw["table"]))
    return a, k
