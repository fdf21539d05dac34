"""Deploy frozen learned predictors as ``family="pc"`` MechanismSpecs (port
of ``repro.learn.mechanism``).

A new predictor family, weights learned offline from oracle traces, is
registered with no edit to the engine or the sweep layer. The frozen
numpy weights ride a :class:`repro_torch.core.mechanisms.ParamHook`, so

* inside the epoch they are f32 tensors on the simulation's device,
  copied there once (one small matmul per epoch, no host traffic),
* specs compare by weight VALUE: reloading the same artifact reuses every
  built step, retraining builds a fresh specialised family, and neither
  touches the shared builtin fork family,
* registration runs the axis-liveness audit: the hooks consume every
  axis, and the auditor derives that from the operations they run.

These specs run the unfused body with the plain table lookup, as the
reference routes custom specs; in a sweep beside them the builtin fork
mechanisms step on the fused epoch kernel.

The predict hook computes ``models.FEATURE_NAMES`` online from the
carry/context view every builtin predictor sees (the engine maintains the
PC table for custom pc-family specs), applies the frozen head and lowers
the predicted ``(i0, sens)`` through the public ``predict_instr``. The
update hook keeps ``carry.react_*`` as an EMA of the exact fork-linear
digest: the recursion the dataset reconstructs offline.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import mechanisms as MECH
from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.core import simulate as SIM
from repro_torch.learn import models as LM

# Learned pc-family specs consume every axis: the engine-imposed floor for
# pc (execution model + mask + power + objective + table EMA) is already
# the full set, and the hooks add nothing dead.
LEARNED_AXES = MECH.SIM_AXES_FIELDS


def epoch_features(carry, ctx, st, ax) -> torch.Tensor:
    """(CU, n_features) online feature matrix: the deployed counterpart
    of ``dataset._run_features`` (same names, order and semantics)."""
    tid = torch.div(torch.arange(st.n_cu, device=ctx.blk.device),
                    st.cus_per_table, rounding_mode="floor")
    idx = PRED.table_index(ctx.blk, st.entries, st.offset_blocks)
    i0_wf, s_wf, hit = PRED.table_lookup(carry.table, tid, idx,
                                         carry.wf_i0, carry.wf_sens)
    pbar = carry.e_acc / torch.clamp(carry.t_acc, min=1e-3)
    return torch.stack([i0_wf.sum(-1), s_wf.sum(-1),
                        carry.react_i0, carry.react_sens,
                        carry.f_prev, pbar, hit.mean(-1)], dim=-1)


def learned_predict(carry, ctx, st, ax, *, params) -> torch.Tensor:
    """Frozen residual head over the online features (reactive digest +
    learned correction, ``models.predict_targets``), lowered to the
    capacity-clipped (CU, n_freqs) prediction the controller consumes."""
    out = LM.predict_targets(params, epoch_features(carry, ctx, st, ax))
    return SIM.predict_instr(out[:, 0], out[:, 1], st, ax)


def learned_update(counters, f_sel, I_f, carry, ctx, st, ax):
    """EMA digest of the exact fork linear into ``carry.react_*`` (the
    react_i0/react_sens features; beta = ``models.REACT_BETA``)."""
    F = PWR.freqs_ghz(ax.power, st.power.n_freqs)
    T = ax.epoch_us
    sens = (I_f[:, -1] - I_f[:, 0]) / ((F[-1] - F[0]) * T)
    i0 = I_f[:, 0] / T - sens * F[0]
    b = LM.REACT_BETA
    return ((1.0 - b) * carry.react_i0 + b * i0,
            (1.0 - b) * carry.react_sens + b * sens)


def make_learned_spec(name: str, params: Dict[str, np.ndarray], *,
                      label: str = "", color: Optional[str] = None,
                      hit_telemetry: bool = True) -> MECH.MechanismSpec:
    """Wrap frozen weights into an (unregistered) pc-family spec."""
    kind = LM.kind_of(params)
    return MECH.MechanismSpec(
        name, "pc", exec_axes=LEARNED_AXES,
        label=label or f"Learned ({kind})", color=color,
        hit_telemetry=hit_telemetry,
        predict=MECH.ParamHook(learned_predict, params),
        update=learned_update)


def register_learned(name: str, params: Dict[str, np.ndarray], *,
                     label: str = "", color: Optional[str] = None,
                     allow_override: bool = False) -> MECH.MechanismSpec:
    """Register a frozen model under ``name`` (audited like any custom
    spec); returns the spec for direct ``run_grid``/``run_sim`` use."""
    return MECH.register(
        make_learned_spec(name, params, label=label, color=color),
        allow_override=allow_override)
