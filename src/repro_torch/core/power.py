"""GPU V/f-domain power model (port of ``repro.core.power``).

P_total = (P_dyn + P_leak) / eta_ivr with P_dyn = C_eff * V^2 * f * A and
P_leak = k_leak * V; V(f) is linear over the ladder. Transition overhead is
an energy C * dV^2 plus a dead time ``min(lat_per_us * epoch_us,
lat_cap_us)``.

The regime is split like the reference: :class:`PowerStatic` (the ladder
length, which sets shapes), :class:`PowerAxes` (the regime as 0-dim f32
tensors on a device) and :class:`PowerConfig` (the user-facing frozen
point). Every model function takes either a ``PowerConfig`` (Python floats)
or a ``PowerAxes`` (tensors) and keeps the reference's op order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclass(frozen=True)
class PowerStatic:
    """Shape half of the power model: the V/f ladder length."""
    n_freqs: int = 10

    def __post_init__(self):
        assert self.n_freqs >= 2, \
            f"a V/f ladder needs >= 2 states, got {self.n_freqs}"


class PowerAxes(NamedTuple):
    """One IVR/hardware regime as 0-dim f32 tensors (field order is the
    packed (11,) power operand of the fused epoch kernel)."""
    f_min: torch.Tensor
    f_max: torch.Tensor
    v_min: torch.Tensor
    v_max: torch.Tensor
    c_eff: torch.Tensor
    k_leak: torch.Tensor
    eta0: torch.Tensor
    eta_slope: torch.Tensor
    c_trans: torch.Tensor
    lat_per_us: torch.Tensor
    lat_cap_us: torch.Tensor


@dataclass(frozen=True)
class PowerConfig:
    v_min: float = 0.70       # V at f_min
    v_max: float = 1.00       # V at f_max
    f_min: float = 1.3
    f_max: float = 2.2
    c_eff: float = 1.0        # arbitrary capacitance unit per CU
    k_leak: float = 0.35      # leakage at V=1 equals ~20% of dyn at fmax
    eta0: float = 0.92        # IVR efficiency at v_min
    eta_slope: float = -0.05  # efficiency droop towards v_max
    c_trans: float = 0.005    # transition energy per unit dV^2
    lat_per_us: float = 4e-3  # paper §5: 4ns dead time per 1us of epoch
    lat_cap_us: float = 0.4   # ... capped at 400ns (the 100us point)
    n_freqs: int = 10         # ladder length (static: it sets shapes)

    def static_part(self) -> PowerStatic:
        return PowerStatic(n_freqs=self.n_freqs)

    def axes(self, device: DeviceLike = "cuda") -> PowerAxes:
        """The regime as f32 tensors on ``device`` (filled on the device:
        no host-to-device copy)."""
        dev = resolve_device(device)
        return PowerAxes(*(torch.full((), getattr(self, f),
                                      dtype=torch.float32, device=dev)
                           for f in PowerAxes._fields))


# the paper's operating point: the default of every model function below
DEFAULT = PowerConfig()

PowerParams = Union[PowerConfig, PowerAxes]

F_STATIC = 1.7  # normalization baseline (paper Figs 15/17)


def _f32(x, device: torch.device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device``; a Python number is filled on
    the device (no host-to-device copy, so no sync inside the epoch
    loop)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def freqs_ghz(pw: PowerParams, n_freqs: Optional[int] = None,
              device: DeviceLike = "cpu") -> torch.Tensor:
    """The V/f ladder: ``n_freqs`` states linearly spaced on
    [``pw.f_min``, ``pw.f_max``], with the exact endpoint appended. The
    blend ``lo*(1-t) + hi*t`` is evaluated as the reference's compiled
    engine evaluates it (t = i * f32(1/(n-1)), hi*t as i * (hi * r)), so
    the default ladder is bitwise the reference's ``FREQS_GHZ``. A
    ``PowerAxes`` carries no shape, so pass ``n_freqs`` with it; its
    tensors also fix the device."""
    if n_freqs is None:
        n_freqs = pw.n_freqs
    assert n_freqs >= 2, n_freqs
    if isinstance(pw.f_min, torch.Tensor):
        dev = pw.f_min.device
    else:
        dev = resolve_device(device)
    lo, hi = _f32(pw.f_min, dev), _f32(pw.f_max, dev)
    i = torch.arange(n_freqs - 1, dtype=torch.float32, device=dev)
    # repro: waive[REPRO001] a numpy scalar of the static ladder length
    r = float(np.float32(1.0) / np.float32(n_freqs - 1))
    return torch.cat([lo * (1.0 - i * r) + i * (hi * r), hi.reshape(1)])


FREQS_GHZ = freqs_ghz(DEFAULT)  # default ladder on the CPU: 10 states


def v_of_f(f, pw: PowerParams = DEFAULT):
    t = (f - pw.f_min) / (pw.f_max - pw.f_min)
    return pw.v_min + t * (pw.v_max - pw.v_min)


def ivr_eta(v, pw: PowerParams = DEFAULT):
    t = (v - pw.v_min) / (pw.v_max - pw.v_min)
    return pw.eta0 + pw.eta_slope * t


def power(f, activity, pw: PowerParams = DEFAULT):
    """Power of one V/f domain at frequency f (GHz) with activity in
    [0,1]."""
    v = v_of_f(f, pw)
    p_dyn = pw.c_eff * v * v * f * torch.clamp(activity, 0.05, 1.0)
    p_leak = pw.k_leak * v
    return (p_dyn + p_leak) / ivr_eta(v, pw)


def transition_energy(f_old, f_new, pw: PowerParams = DEFAULT):
    dv = v_of_f(f_new, pw) - v_of_f(f_old, pw)
    return pw.c_trans * dv * dv


def transition_latency_us(epoch_us, pw: PowerParams = DEFAULT):
    """V/f transition dead time ``min(lat_per_us * epoch_us,
    lat_cap_us)``; tensors in, tensor out (floats in, float out)."""
    lat = pw.lat_per_us * epoch_us
    if isinstance(lat, torch.Tensor):
        return torch.minimum(lat, _f32(pw.lat_cap_us, lat.device))
    return min(lat, pw.lat_cap_us)
