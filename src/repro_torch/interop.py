"""Carry state across from the JAX package, as numpy arrays.

Plain functions that turn numpy arrays (never JAX arrays: this module
imports neither JAX nor ``repro``) into the port's tensors on a device, so
a comparison can start both packages from the same bits. This matters most
for ``Program.cum3``: the reference builds it with an XLA f32 cumsum,
which is not guaranteed to round like ``torch.cumsum``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import power as PWR
from repro_torch.core import predictors as PRED
from repro_torch.core import simulate as SIM
from repro_torch.core.workloads import Program
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import OptState


def _t(a, device: DeviceLike, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype).to(
        resolve_device(device))


def program_from_numpy(name: str, i0_rate, sens_rate, mem_frac, cum3,
                       device: DeviceLike = "cuda") -> Program:
    """A ``Program`` from its (P,) rate arrays and (2P+1, 3) prefix sums."""
    return Program(name, _t(i0_rate, device), _t(sens_rate, device),
                   _t(mem_frac, device), _t(cum3, device))


def table_from_numpy(i0, sens, count,
                     device: DeviceLike = "cuda") -> PRED.PCTable:
    """A ``PCTable`` from its three (n_tables, entries) arrays."""
    return PRED.PCTable(_t(i0, device), _t(sens, device), _t(count, device))


def carry_from_numpy(*, pos, react_i0, react_sens, wf_i0, wf_sens, table,
                     f_prev, e_acc, t_acc,
                     device: DeviceLike = "cuda") -> SIM.Carry:
    """A ``Carry`` from numpy fields; ``table`` is an (i0, sens, count)
    triple of arrays."""
    return SIM.Carry(
        pos=_t(pos, device), react_i0=_t(react_i0, device),
        react_sens=_t(react_sens, device), wf_i0=_t(wf_i0, device),
        wf_sens=_t(wf_sens, device),
        table=table_from_numpy(*table, device=device),
        f_prev=_t(f_prev, device), e_acc=_t(e_acc, device),
        t_acc=_t(t_acc, device).reshape(()))


def power_axes_from_numpy(pw_vec, device: DeviceLike = "cuda"
                          ) -> PWR.PowerAxes:
    """A ``PowerAxes`` from the (11,) power vector in field order (the
    fused epoch kernel's packed power operand)."""
    vec = _t(pw_vec, device)
    assert vec.shape == (len(PWR.PowerAxes._fields),), vec.shape
    return PWR.PowerAxes(*vec.unbind(0))


def sim_axes_from_numpy(scal, pw_vec, n_ep: int,
                        device: DeviceLike = "cuda") -> SIM.SimAxes:
    """A ``SimAxes`` from the (9,) packed sweep scalars [epoch_us, sigma,
    cap_per_ghz, membw, table_ema, obj0..2, lat_us], the (11,) power
    vector and the logical epoch count. ``lat_us`` is not a ``SimAxes``
    field: the engine derives it from the power regime."""
    s = _t(scal, device)
    assert s.shape == (9,), s.shape
    return SIM.SimAxes(
        epoch_us=s[0], sigma=s[1], cap_per_ghz=s[2], membw=s[3],
        table_ema=s[4], obj=s[5:8].clone(),
        n_ep=torch.full((), n_ep, dtype=torch.int32, device=s.device),
        power=power_axes_from_numpy(pw_vec, device))


# ---------------------------------------------------------------------------
# grid rows: the batched sweep's operands with a leading row axis
# ---------------------------------------------------------------------------


def stacked_programs_from_numpy(i0_rate, sens_rate, mem_frac, cum3,
                                device: DeviceLike = "cuda") -> Program:
    """W padded programs stacked on a leading axis, as the sweep's
    ``_stack_programs`` lays them out: (W, Pp) rates and (W, 2Pp+1, 3)
    prefix sums."""
    prog = program_from_numpy("suite", i0_rate, sens_rate, mem_frac, cum3,
                              device)
    W, Pp = prog.i0_rate.shape
    assert prog.cum3.shape == (W, 2 * Pp + 1, 3), prog.cum3.shape
    return prog


def carry_rows_from_numpy(*, pos, react_i0, react_sens, wf_i0, wf_sens,
                          table, f_prev, e_acc, t_acc,
                          device: DeviceLike = "cuda") -> SIM.Carry:
    """R per-row carries (every field with a leading row axis, ``t_acc``
    (R,)), as ``simulate.init_carry`` of an (R,) block-count tensor lays
    them out; ``table`` is an (i0, sens, count) triple of (R, T, E)
    arrays."""
    carry = SIM.Carry(
        pos=_t(pos, device), react_i0=_t(react_i0, device),
        react_sens=_t(react_sens, device), wf_i0=_t(wf_i0, device),
        wf_sens=_t(wf_sens, device),
        table=table_from_numpy(*table, device=device),
        f_prev=_t(f_prev, device), e_acc=_t(e_acc, device),
        t_acc=_t(t_acc, device))
    R = carry.pos.shape[0]
    assert carry.t_acc.shape == (R,), carry.t_acc.shape
    assert all(x.shape[0] == R for x in carry[:-1] if torch.is_tensor(x))
    return carry


def sim_axes_rows_from_numpy(scal, pw_vec, n_ep,
                             device: DeviceLike = "cuda") -> SIM.SimAxes:
    """A ``SimAxes`` whose leaves carry a leading row axis, from (R, 9)
    packed sweep scalars, (R, 11) power vectors and (R,) logical epoch
    counts (``lat_us``, the scalars' last column, is derived by the engine
    and dropped)."""
    s = _t(scal, device)
    pw = _t(pw_vec, device)
    R = s.shape[0]
    assert s.shape == (R, 9) and pw.shape == (R, len(PWR.PowerAxes._fields))
    return SIM.SimAxes(
        epoch_us=s[:, 0].clone(), sigma=s[:, 1].clone(),
        cap_per_ghz=s[:, 2].clone(), membw=s[:, 3].clone(),
        table_ema=s[:, 4].clone(), obj=s[:, 5:8].clone(),
        n_ep=_t(n_ep, device, torch.int32).reshape(R),
        power=PWR.PowerAxes(*(c.clone() for c in pw.unbind(1))))


def _leaf(a) -> torch.Tensor:
    """A numpy array as a CPU tensor with its bits; a bfloat16 array
    (numpy's extension dtype) is reinterpreted through int16."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(cfg, tree) -> dict:
    """The port's state dict (``models.model.init_params``'s names) from the
    reference's params tree with numpy leaves, the per-layer leaves stacked
    on a leading layer axis. Load it with ``params.load_state_dict``."""
    out = {}

    def walk(node, prefix, layer=None):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.", layer)
            else:
                out[prefix + key] = _leaf(val if layer is None
                                          else np.asarray(val)[layer])

    for key, val in tree.items():
        if key == "layers":
            for i in range(cfg.n_layers):
                walk(val, f"layers.{i}.", i)
        else:
            out[key] = _leaf(val)
    return out


def state_from_numpy(cfg, state, device: DeviceLike = "cpu") -> dict:
    """The port's training state (``train.train_step.init_state``'s
    layout) from the reference's ``TrainState`` with numpy leaves:
    ``params`` (a trainable params tree), ``opt`` (``OptState`` of the m
    and v dicts by the params' names and ``count``), ``step`` and, under
    int8_ef, ``ef``."""
    dev = resolve_device(device)

    def tree(t):
        return {k: v.to(dev) for k, v in params_from_numpy(cfg, t).items()}

    params = init_params(cfg, 0, dev, trainable=True)
    params.load_state_dict(tree(state["params"]))
    m, v, count = state["opt"]
    out = {"params": params,
           "opt": OptState(tree(m), tree(v), _t(count, dev, torch.int32)),
           "step": _t(state["step"], dev, torch.int32)}
    if "ef" in state:
        out["ef"] = tree(state["ef"])
    return out
